"""The dataset collectors: the four stages of the ground-truth pipeline, and
their kernels.

The port of ``deepestscatter_tpu.data.collectors`` (reference: the
collector SceneItems):

1. ``generate_scatter_samples``: first-scatter (position, direction) pairs
   by rejection: a uniform sphere normal, a uniform disc point of radius
   sqrt(3)/2, a ray at the cloud, the first scatter inside the box
   (pointGeneratorCamera.cu).  Its kernel is K7a (``csrc/samples.cu``), a
   block a sample making its attempts in rounds of ``kSampleWarps``;
   ``generate_scatter_samples_plain`` is the lockstep loop over
   ``ops.march.next_scattering_event``.
2. ``estimate_point_radiance``: Monte-Carlo multiple-scatter radiance at
   each sample with the reference's CI gates and its host-driven
   reschedule/densify loop (RadianceCollector.cpp:105-141): converged points
   leave the schedule, the thread budget is re-divided among the survivors.
   Each update is one launch of K7b (``radiance_moments``:
   ``csrc/pathtrace.cu::ds_radiance``, K4's item queue over (point,
   replica) lanes with a per-lane experiment base and the scatters deferred
   in the warp); ``radiance_moments_plain`` runs K4's plain version with
   the same bases.
3. ``collect_disney_descriptors``: the 10-layer 5x5x9 uint8 descriptor at
   each sample (K2, then ``ops.descriptor.quantize_u8``).
4. ``collect_baked_sets``: the 4 tetrahedral probes around each sample,
   each with its descriptor in the frame of the probe direction (0, 0, 1)
   (K2), its barycentric power and its position.

Random numbers are keyed by (seed, sample id, counter): attempt k of a
sample draws at counters 8k .. 8k+4; experiment e of a sample uses the
seed ``seed ^ (e * 0x9E3779B1)`` (uint32), where e counts the sample's
experiments over all updates, so a run resumes and reschedules without
changing them.  Positions are world-centred (local minus bbox / 2).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import cuda_build
from ..config import PointRadianceConfig, RenderMode
from ..device import check_on
from ..ops import descriptor as desc_ops
from ..ops import march as march_ops
from ..ops import rng as rng_ops
from ..ops import tetra as tetra_ops
from ..ops import welford as welford_ops
from ..render import baked as baked_mod
from ..render import camera as camera_ops
from ..render import pathtracer
from ..scene import SceneParams, SceneStatic, is_in_box
from . import records

#: float32(sqrt(3) / 2): the disc radius of the sample rays.
SQRT3_2 = float(np.float32(math.sqrt(3.0) / 2.0))
#: RNG draw sites per attempt (2 sphere, 2 disc, 1 od; 8 reserved).
DRAWS_PER_ATTEMPT = 8
MAX_ATTEMPTS = 256


class ScatterSamples(NamedTuple):
    positions: torch.Tensor  # [n, 3] world-centred scatter points (0 where not found)
    directions: torch.Tensor  # [n, 3] ray directions (0 where not found)
    found: torch.Tensor  # [n] bool
    attempts: torch.Tensor  # [n] int64: attempts made (256 where not found)
    steps: torch.Tensor  # [n] int64: march steps over the attempts


def attempt_rays(params: SceneParams, static: SceneStatic, ids: torch.Tensor, seed: int,
                 k: int):
    """Attempt ``k`` of the samples ``ids`` → (hit [m] bool, entry [m, 3]
    local coordinates, direction [m, 3], od [m])."""
    ctr = k * DRAWS_PER_ATTEMPT
    u1, u2, u3, u4, od = (rng_ops.hash_uniform(seed, ids, ctr + j) for j in range(5))
    normal = rng_ops.uniform_on_sphere(u1, u2)
    disc = rng_ops.uniform_on_disc(u3, u4, normal) * SQRT3_2
    origin = disc + normal * 2.0
    ray_dir = -normal
    hit, t_hit = camera_ops.intersect_box(origin, ray_dir, static, params.bbox_size)
    entry = camera_ops.entry_points(origin, ray_dir, t_hit, params.bbox_size)
    return hit, entry, ray_dir, od


#: Attempts the plain version marches side by side (its lanes are (attempt,
#: sample) pairs; each attempt's march is independent of the others').
PLAIN_ROUND = 8


def generate_scatter_samples_plain(
    params: SceneParams, static: SceneStatic, n: int, seed: int
) -> ScatterSamples:
    """Plain PyTorch version of K7a: the attempts of every sample not yet
    found, for k = 0 .. 255 (the JAX loop, which also stops once all are
    found); the march runs on the attempts whose ray hits the box, to the
    scatter (``stop_at_scatter``), with the scene's skip
    (``march_ops.skip_mode``: the block skip, else the cell jump).  The
    attempts are marched PLAIN_ROUND at a time, side by side: a sample
    takes the first accepted one, and counts the steps of the attempts up
    to it (all of them where none was accepted), as the loop over single
    attempts does."""
    dev = params.bbox_size.device
    f32, i64 = torch.float32, torch.int64
    half = 0.5 * params.bbox_size
    pos = torch.zeros((n, 3), dtype=f32, device=dev)
    dirs = torch.zeros((n, 3), dtype=f32, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    attempts = torch.full((n,), MAX_ATTEMPTS, dtype=i64, device=dev)
    steps = torch.zeros((n,), dtype=i64, device=dev)
    skip = march_ops.skip_mode(static)
    for k0 in range(0, MAX_ATTEMPTS, PLAIN_ROUND):
        todo = torch.nonzero(~found).flatten()
        m = todo.numel()
        if m == 0:
            break
        r = min(PLAIN_ROUND, MAX_ATTEMPTS - k0)
        rays = [attempt_rays(params, static, todo, seed, k0 + j) for j in range(r)]
        hit, entry, ray_dir, od = (torch.cat(t) for t in zip(*rays))  # attempt-major lanes
        h = torch.nonzero(hit).flatten()
        ev = march_ops.next_scattering_event(params, static, od[h], entry[h].contiguous(),
                                             ray_dir[h].contiguous(), stop_at_scatter=True,
                                             skip=skip)
        lane_steps = torch.zeros((r * m,), dtype=i64, device=dev)
        lane_steps[h] = ev.steps
        ok = torch.zeros((r * m,), dtype=torch.bool, device=dev)
        ok[h] = ev.has_scattered & is_in_box(ev.scatter_pos, params.bbox_size)
        lane_pos = torch.zeros((r * m, 3), dtype=f32, device=dev)
        lane_pos[h] = ev.scatter_pos
        ok = ok.reshape(r, m)
        won = ok.any(dim=0)
        first = torch.where(won, torch.argmax(ok.to(torch.int32), dim=0),
                            torch.full_like(todo, r - 1))
        upto = torch.arange(r, device=dev)[:, None] <= first[None, :]
        steps[todo] += (lane_steps.reshape(r, m) * upto).sum(dim=0)
        lane = first * m + torch.arange(m, device=dev)
        acc = won.nonzero().flatten()
        ids = todo[acc]
        pos[ids] = lane_pos[lane[acc]] - half
        dirs[ids] = ray_dir[lane[acc]]
        found[ids] = True
        attempts[ids] = k0 + first[acc] + 1
    return ScatterSamples(pos, dirs, found, attempts, steps)


_SAMPLE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
    ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _launch_samples(params, static, n, seed, lib=None) -> ScatterSamples:
    """K7a on the scene's device: ``ds_samples``, or ``ds_samples_skip``
    with the scene's skip.  ``lib``: another library with the same entry
    points (the tests' host build of the kernel's device functions, the
    alternatives ``probes/march_variants.py`` times)."""
    dens = params.density_mips[0]
    if dens.dtype not in (torch.uint8, torch.float32) or not dens.is_contiguous():
        raise ValueError("the density texture must be a contiguous uint8 or float32 grid")
    if dens.numel() >= 2**31:
        raise ValueError("K7a indexes textures in 32 bits: fewer than 2^31 texels")
    skip = march_ops.skip_mode(static)
    march_ops.check_skip(params, static, skip)
    lib = lib or cuda_build.load("samples")
    fn = lib.ds_samples_skip if skip else lib.ds_samples
    fn.argtypes = _SAMPLE_ARGTYPES + (march_ops.SKIP_ARGTYPES if skip else [])
    fn.restype = ctypes.c_int
    dev = dens.device
    pos = torch.empty((n, 3), dtype=torch.float32, device=dev)
    dirs = torch.empty((n, 3), dtype=torch.float32, device=dev)
    found = torch.empty((n,), dtype=torch.uint8, device=dev)
    work = torch.empty((n, 2), dtype=torch.int32, device=dev)
    consts = (ctypes.c_float * 18)(
        *static.bbox, *static.cloud_aabb[:3], *static.cloud_aabb[3:],
        static.sample_step, static.density_multiplier,
        *static.light_direction, *static.light_rgb, static.sun_solid_angle_ratio,
    )
    nz, ny, nx = static.grid_shape
    cuda_build.check(
        fn(
            cuda_build.ptr(dens), int(dens.dtype == torch.uint8), nx, ny, nz,
            int(seed) & 0xFFFFFFFF, n, consts, static.max_march_steps,
            static.minimal_ray_distance, cuda_build.ptr(pos), cuda_build.ptr(dirs),
            cuda_build.ptr(found), cuda_build.ptr(work), cuda_build.stream_handle(),
            *(march_ops.skip_args(params, static, skip) if skip else []),
        ),
        "scatter-sample kernel",
    )
    generate_scatter_samples.launches += 1
    return ScatterSamples(pos, dirs, found.to(torch.bool), work[:, 0].long(), work[:, 1].long())


def generate_scatter_samples(
    params: SceneParams, static: SceneStatic, n: int, seed: int
) -> ScatterSamples:
    """K7a's wrapper: ``n`` first-scatter samples of stream ids 0 .. n-1 on
    the scene's device — the kernel on the card, the plain version on the
    CPU (same values)."""
    if params.bbox_size.is_cuda:
        return _launch_samples(params, static, n, seed)
    return generate_scatter_samples_plain(params, static, n, seed)


#: Kernel launches so far (counted where K7a is launched, nowhere else).
generate_scatter_samples.launches = 0


class RadianceEstimate(NamedTuple):
    radiance: np.ndarray  # [n] mean multiple-scatter radiance (red channel)
    is_converged: np.ndarray  # [n] bool
    experiments: np.ndarray  # [n] int64 experiment counts
    #: (active points, replicas) of each update: the reschedule/densify record.
    schedule: Tuple[Tuple[int, int], ...] = ()
    #: [n] the absolute 95 % CI half-width of each label at the end.
    ci95: np.ndarray = None


def radiance_static(static: SceneStatic) -> SceneStatic:
    """Labels are multiple-scatter radiance only (the collect mode), marched
    without the block skip: the JAX package's deferred loop, which the
    collector runs, takes the empty-cell jump (``march_empty_skip``) and
    ignores the occupancy."""
    return dataclasses.replace(static, mode=RenderMode.SUN_MULTIPLE_SCATTER,
                               occupancy_skip_steps=0)


def bucket_size(n_active: int) -> int:
    """The padded active-set size: the power of two >= max(8, n_active)."""
    b = 8
    while b < n_active:
        b *= 2
    return b


def _lanes(entry, dirs, rids, exp_base, replicas: int, launches: int):
    """(point, replica) lanes, replica-major: entries, directions, sample
    ids and experiment bases ``exp_base + replica * launches`` (wrapped
    to uint32 by the loop)."""
    bucket = entry.shape[0]
    r = torch.arange(replicas, dtype=torch.int64, device=entry.device) * launches
    sub0 = (exp_base.repeat(replicas) + r.repeat_interleave(bucket)) & 0xFFFFFFFF
    return (entry.repeat(replicas, 1).contiguous(), dirs.repeat(replicas, 1).contiguous(),
            rids.repeat(replicas).contiguous(), sub0)


def _point_moments(pm: pathtracer.PixelMoments, replicas: int):
    """Per-lane Welford states (red channel) → per-point raw moments
    (count, sum x, sum x^2), summed over the replicas with the counts each
    lane actually folded."""
    cnt, s1, s2 = welford_ops.to_moments(
        welford_ops.Welford(pm.mean[:, 0], pm.m2[:, 0], pm.count))
    bucket = cnt.shape[0] // replicas
    return tuple(t.reshape(replicas, bucket).sum(dim=0) for t in (cnt, s1, s2))


def radiance_moments_plain(params, static, entry, dirs, rids, exp_base, seed: int,
                           replicas: int, launches: int):
    """Plain PyTorch version of K7b: K4's plain loop over the (point,
    replica) lanes, ``launches`` experiments each, in the static's mode,
    with the cell jump where ``march_empty_skip``."""
    o, d, ids, sub0 = _lanes(entry, dirs, rids, exp_base, replicas, launches)
    hit = torch.ones((o.shape[0],), dtype=torch.bool, device=o.device)
    pm = pathtracer.scatter_loop_plain(params, static, o, d, hit, ids, seed, sub0, launches,
                                       skip=march_ops.skip_mode(static, block=False))
    return _point_moments(pm, replicas)


def launch_radiance(params, static, entry, dirs, ray_ids, sub0, seed: int, launches: int,
                    lib=None):
    """K7b on the lanes' device: ``launches`` experiments on each lane (box
    entries [N, 3], directions [N, 3], sample ids [N] int64, experiment
    bases ``sub0`` [N] int64 of uint32 values) → (the lanes'
    ``PixelMoments``, the per-experiment ``SampleRecords``).  Its records
    take 20 B a lane and experiment: 41 MB at the default 20,480 lanes x
    100.  ``lib``: another library with the same ``ds_radiance`` entry
    point (the tests' host build of the kernel's device functions, the
    alternatives ``probes/march_variants.py`` times)."""
    n = entry.shape[0]
    if sub0.shape != (n,) or sub0.dtype != torch.int64:
        raise ValueError("sub0 must be int64 [N]")
    check_on(entry.device, sub0)
    # The uint32 bits in an int32 tensor (the kernel reads uint32).
    sub32 = sub0 & 0xFFFFFFFF
    sub32 = torch.where(sub32 >= 2**31, sub32 - 2**32, sub32).to(torch.int32).contiguous()
    hit = torch.ones((n,), dtype=torch.bool, device=entry.device)
    pm, rec, counters = pathtracer.launch_entry(
        lib, "ds_radiance", pathtracer.RADIANCE_ARGTYPES, cuda_build.ptr(sub32), params, static,
        entry, dirs, hit, ray_ids, seed, launches, None,
        march_ops.skip_mode(static, block=False))
    radiance_moments.launches += 1
    radiance_moments.last_counters = counters
    return pm, rec


def radiance_moments(params, static, entry, dirs, rids, exp_base, seed: int,
                     replicas: int, launches: int, lib=None):
    """K7b's wrapper: ``replicas x launches`` experiments at each point
    (entries [B, 3] in local coordinates, directions [B, 3], sample ids [B]
    int64, first experiment indices ``exp_base`` [B] int64 of uint32
    values) → per-point (count, sum x, sum x^2) [B] of the red channel.
    The kernel on the card (``launch_radiance``), the plain version on the
    CPU."""
    if entry.is_cuda or lib is not None:
        o, d, ids, sub0 = _lanes(entry, dirs, rids, exp_base, replicas, launches)
        pm, _ = launch_radiance(params, static, o, d, ids, sub0, seed, launches, lib=lib)
        return _point_moments(pm, replicas)
    return radiance_moments_plain(params, static, entry, dirs, rids, exp_base, seed,
                                  replicas, launches)


#: Kernel launches so far (counted where K7b is launched, nowhere else).
radiance_moments.launches = 0
#: The last launch's device counters [4] int64: the queue head, the warps'
#: march slots (as ``pathtracer.scatter_loop``'s), their resolve steps and
#: the crossings those resolved.
radiance_moments.last_counters = None


def estimate_point_radiance(
    params: SceneParams,
    static: SceneStatic,
    positions: torch.Tensor,
    directions: torch.Tensor,
    cfg: PointRadianceConfig = PointRadianceConfig(),
    seed: int = 0,
    max_updates: int = 200,
    verbose: bool = False,
    state_path: str | None = None,
    save_every: int = 10,
) -> RadianceEstimate:
    """Monte-Carlo labels at world-centred ``positions`` [n, 3] seen along
    ``directions`` [n, 3], on the scene's device, with the reference's
    reschedule/densify loop (RadianceCollector.cpp:105-141, 178):

    - each update pads the unconverged points to a power-of-two bucket with
      copies of the first of them (their lanes are traced and dropped) and
      gives each ``replicas = max(1, cfg.max_threads // bucket)`` lanes of
      ``cfg.launches_per_update`` experiments (one K7b launch);
    - the fresh moments merge into the persistent host (numpy) Welford
      state by the counts the lanes actually folded (a lane stopped by the
      step cap folds fewer);
    - a point converges when its 95 % CI is below ``rel_tol`` of its mean
      or below ``abs_tol``; a black point (mean < eps) only once it has
      more than ``black_min_experiments``; converged points leave the
      schedule and their counts freeze.

    The experiment counter is int64 on the host, and the experiment base of
    an update is its low 32 bits.  ``state_path`` saves the host state
    every ``save_every`` updates (atomic npz) and resumes from it; the
    caller removes it once the labels are stored (``tasks.collect``)."""
    n = positions.shape[0]
    dev = params.bbox_size.device
    rstatic = radiance_static(static)
    entry_all = (positions + 0.5 * params.bbox_size).to(torch.float32).contiguous()
    dirs_all = directions.to(torch.float32).contiguous()

    mean = np.zeros(n, np.float32)
    m2 = np.zeros(n, np.float32)
    count = np.zeros(n, np.float32)
    count_int = np.zeros(n, np.int64)
    converged = np.zeros(n, bool)
    eps = np.finfo(np.float32).eps
    r0 = 0
    if state_path and os.path.exists(state_path):
        st = np.load(state_path)
        if st["n"] == n and st["seed"] == seed:
            mean, m2 = st["mean"], st["m2"]
            count, count_int = st["count"], st["count_int"]
            converged = st["converged"]
            r0 = int(st["update"])
            if verbose:
                print(f"radiance resume: update {r0}, {int((~converged).sum())} unconverged",
                      flush=True)

    def save_state(r):
        tmp = state_path + ".tmp.npz"
        np.savez(tmp, n=n, seed=seed, update=r, mean=mean, m2=m2, count=count,
                 count_int=count_int, converged=converged)
        os.replace(tmp, state_path)

    launches = cfg.launches_per_update
    active = np.arange(n)[~converged]
    schedule = []
    for r in range(r0, max_updates):
        if active.size == 0:
            break
        bucket = bucket_size(active.size)
        replicas = max(1, cfg.max_threads // bucket)
        schedule.append((int(active.size), replicas))
        idx = active
        if bucket > active.size:
            idx = np.concatenate([active, np.full(bucket - active.size, active[0])])
        idx_t = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        c_count, c_s1, c_s2 = radiance_moments(
            params, rstatic, entry_all[idx_t], dirs_all[idx_t], idx_t,
            torch.as_tensor(count_int[idx] & 0xFFFFFFFF, dtype=torch.int64, device=dev),
            seed, replicas, launches,
        )
        contrib = welford_ops.from_moments(c_count, c_s1, c_s2)
        k = active.size
        c_mean = contrib.mean[:k].cpu().numpy()
        c_m2 = contrib.m2[:k].cpu().numpy()
        c_count = contrib.count[:k].cpu().numpy()
        expected = float(replicas * launches)
        if not np.all(c_count == expected):
            short = int((c_count != expected).sum())
            print(f"radiance warning: {short} points folded {c_count.min():.0f}.."
                  f"{c_count.max():.0f} experiments (scheduled {expected:.0f}): the step cap "
                  "cut lanes; labels normalize by the actual count", flush=True)

        tot = count[active] + c_count
        safe = np.maximum(tot, 1.0)
        delta = c_mean - mean[active]
        mean[active] += delta * (c_count / safe)
        m2[active] += c_m2 + delta**2 * (count[active] * c_count / safe)
        count[active] = tot
        count_int[active] += replicas * launches

        nsafe = np.maximum(count[active], 1.0)
        ci = 1.96 * np.sqrt(m2[active] / nsafe) / np.sqrt(nsafe)
        conv = (ci / (mean[active] + eps) < cfg.rel_tol) | (ci < cfg.abs_tol)
        black = mean[active] < eps
        conv = np.where(black, count_int[active] > cfg.black_min_experiments, conv)
        converged[active] = conv
        active = active[~conv]
        if verbose:
            print(f"radiance update {r}: {active.size} unconverged "
                  f"(replicas {replicas} x launches {launches})", flush=True)
        if state_path and (r + 1) % save_every == 0:
            save_state(r + 1)
    nsafe = np.maximum(count, 1.0)
    ci95 = 1.96 * np.sqrt(m2 / nsafe) / np.sqrt(nsafe)
    return RadianceEstimate(mean, converged, count_int, tuple(schedule), ci95)


def collect_disney_descriptors(
    params: SceneParams, static: SceneStatic, positions: torch.Tensor,
    directions: torch.Tensor,
) -> np.ndarray:
    """10-layer uint8 descriptor grids [n, 2250] at world-centred
    ``positions`` seen along ``directions`` (disneyDescriptorCollector.cu):
    K2 at 10 layers, omega dropped, ``quantize_u8``."""
    local = (positions + 0.5 * params.bbox_size).contiguous()
    layers = desc_ops.network_inputs(params, static, local, directions.contiguous(),
                                     desc_ops.DISNEY_LAYERS)[:, :, : desc_ops.LAYER_SIZE]
    return desc_ops.quantize_u8(layers).reshape(positions.shape[0], records.GRID_BYTES).cpu().numpy()


def collect_baked_sets(
    params: SceneParams, static: SceneStatic, positions: torch.Tensor
) -> np.ndarray:
    """BakedInterpolationSet records [n] (lightProbeCollector.cu): per
    sample the 4 probes of its tetrahedron, each with its 10-layer uint8
    descriptor in the frame of the probe direction (K2 on the 4 n corners),
    its barycentric power and its world-centred position."""
    n = positions.shape[0]
    half = 0.5 * params.bbox_size
    units = (positions + half) * baked_mod._lattice_units(static)
    corners, weights = tetra_ops.probe_interpolation(units)  # [n, 4, 3], [n, 4]
    spacing = float(np.float32(baked_mod.STEP_IN_MEAN_FREE_PATH / static.density_multiplier))
    flat_pos = (corners.to(torch.float32) * spacing).reshape(n * 4, 3).contiguous()
    frames = baked_mod.probe_frames(n * 4, positions.device)
    layers = desc_ops.network_inputs(params, static, flat_pos, frames, desc_ops.DISNEY_LAYERS,
                                     frame_dir=frames)[:, :, : desc_ops.LAYER_SIZE]
    grids = desc_ops.quantize_u8(layers).reshape(n, 4, records.GRID_BYTES).cpu().numpy()
    probe_world = (flat_pos - half).reshape(n, 4, 3).cpu().numpy()
    powers = weights.cpu().numpy()
    out = np.zeros(n, records.BAKED_INTERPOLATION_SET)
    for i, corner in enumerate(("a", "b", "c", "d")):
        out[corner]["grid"] = grids[:, i]
        out[corner]["position"] = probe_world[:, i]
        out[corner]["direction"] = np.asarray(baked_mod.PROBE_DIRECTION, np.float32)
        out[corner]["power"] = powers[:, i]
    return out
