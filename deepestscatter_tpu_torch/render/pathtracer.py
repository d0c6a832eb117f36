"""Progressive Monte-Carlo volumetric path tracer: the ground-truth renderer,
and its bounce-loop CUDA kernel (K4, ``csrc/pathtrace.cu``).

The port of ``deepestscatter_tpu.render.pathtracer`` with the estimator of
its oracle loop ``_scatter_loop`` (``march_deferred=False``), for the
reference's three closest-hit programs (cloudRadianceMaterials.cu):

- ``SUN_AND_SKY_ALL_SCATTER``: bounce loop with NEE at every scatter, the
  full Mie phase at depth 1 and the chopped phase after it;
- ``SUN_MULTIPLE_SCATTER``: the direction is resampled before the loop
  (counters 0 and 1), so single scattering is excluded; chopped phase
  throughout;
- ``SUN_SINGLE_SCATTER``: one free flight (``od`` at counter 0), NEE with
  the full phase at the scatter point.

Per sample: fixed steps ``pos += dir * step`` from the box entry and from
each scatter point, ``T *= exp(-sigma * step)``; the first step with
``od > T`` scatters, pulled back by ``log(od / T) / sigma``; ``od`` draws
at counter ``4 * depth``, the new direction at ``+1`` / ``+2``, roulette at
``+3``.  A sample ends on leaving the box (+-0.01 margin), at ``max_depth``
bounces, by roulette, or after ``max_total_steps`` steps, where it is cut
and still counts as a sample.  Sample ``k`` of a pixel uses the seed
``seed_base ^ ((sub_first + k) * 0x9E3779B1)``; its Welford fold happens in
sample order.

The JAX package's TPU scheduling (deferred resolves, compaction cascade)
is not ported: the kernel's warps take (pixel, sample) items from a queue,
march them a few steps at a time, write one record a sample and fold the
records per pixel in sample order (notes in ``csrc/pathtrace.cu``).  Its
empty-space skips are (``ops.march.skip_mode``): the occupancy-block skip
of its oracle loop and single-scatter march where
``occupancy_skip_steps`` >= 2, else the empty-cell exit jump of its
deferred loop where ``march_empty_skip``; both off by default.
``scatter_loop`` is the kernel's wrapper: K4 for CUDA tensors,
``scatter_loop_plain`` (the same function in lockstep PyTorch) for CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import cuda_build
from ..config import RenderMode
from ..device import check_on, resolve_device
from ..ops import grid as grid_ops
from ..ops import march as march_ops
from ..ops import phase as phase_ops
from ..ops import rng as rng_ops
from ..ops.march import back_correct_distance
from ..scene import SceneParams, SceneStatic, is_in_box
from . import camera as camera_ops

#: RNG draw sites per bounce (optical distance, cos theta, azimuth, roulette).
DRAWS_PER_BOUNCE = 4

#: Lockstep iterations of the plain loop between its host-side "any lane
#: still busy?" checks (extra iterations on finished lanes change nothing);
#: under autograd, the iterations each checkpoint rematerializes.
_CHECK_EVERY = 16


def sample_inscatter(params: SceneParams, pos: torch.Tensor) -> torch.Tensor:
    """Baked sun transmittance at local positions ``pos`` [..., 3]."""
    return grid_ops.sample_trilinear(params.inscatter, pos / params.bbox_size)


def in_scattering(
    params: SceneParams,
    static: SceneStatic,
    scatter_pos: torch.Tensor,
    direction: torch.Tensor,
    chopped=False,
    trans_sun: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Next-event estimation toward the sun disc (cloud.cuh:146-158): light
    radiance x baked sun transmittance x phase x sun solid-angle ratio →
    [N, 3].  ``chopped`` (bool or [N] bool) selects the chopped phase;
    ``trans_sun``: the baked transmittance at ``scatter_pos`` where the
    caller sampled it (a slab's, K9), else read from ``params``."""
    p_full, p_chop = phase_ops.eval_phase_pair(
        params.phase, camera_ops.cos_to_sun(params.light_dir, direction)
    )
    if isinstance(chopped, torch.Tensor):
        p = torch.where(chopped, p_chop, p_full)
    else:
        p = p_chop if chopped else p_full
    if trans_sun is None:
        trans_sun = sample_inscatter(params, scatter_pos)
    scale = p * trans_sun * static.sun_solid_angle_ratio
    return params.light_radiance * scale[..., None]


def new_direction(
    params: SceneParams,
    prev_direction: torch.Tensor,
    u_cdf: torch.Tensor,
    u_phi: torch.Tensor,
) -> torch.Tensor:
    """The next direction (cloud.cuh:160-188): inverse-CDF cos theta of the
    chopped phase, uniform azimuth around the previous direction,
    normalized."""
    cos_theta = phase_ops.sample_cos_theta_fast(params.phase, u_cdf)
    local = rng_ops.uniform_on_sphere_circle(u_phi, cos_theta)
    d = rng_ops.from_onb(local, prev_direction)
    return d / camera_ops.norm3(d)[..., None]


def sky_exit_radiance(
    params: SceneParams,
    static: SceneStatic,
    direction: torch.Tensor,
    depth: torch.Tensor,
    weight: torch.Tensor,
) -> torch.Tensor:
    """Light of a path leaving the box with ``sample_sky`` on: the sky
    gradient, plus the sun disc while nothing has scattered yet (depth 1),
    times the path weight."""
    sun = camera_ops.sun_disc(params, static, direction)
    add = camera_ops.sky_gradient(params, direction) + torch.where(
        (depth == 1)[:, None], sun, torch.zeros_like(sun)
    )
    return add * weight[:, None]


class PixelMoments(NamedTuple):
    """Per-pixel Welford triple of the traced samples, plus work counts."""

    mean: torch.Tensor  # [N, 3]
    m2: torch.Tensor  # [N, 3]
    count: torch.Tensor  # [N] float32: samples folded (0 where not hit)
    steps: torch.Tensor  # [N] int64: march steps sampled over all samples
    bounces: torch.Tensor  # [N] int64: free flights that ended in the box
    #: [N] int64: lattice steps advanced without a sample (the skips: the
    #: cell jumps, and a long step's steps but its one sample).
    jumped: torch.Tensor


class _Mode(NamedTuple):
    single: bool
    resample: bool  # redraw the first direction per sample (counters 0/1)
    chopped_at_depth1: bool
    sky: bool


def _mode(static: SceneStatic) -> _Mode:
    m = static.mode
    if m is RenderMode.SUN_AND_SKY_ALL_SCATTER:
        return _Mode(False, False, False, bool(static.sample_sky))
    if m is RenderMode.SUN_MULTIPLE_SCATTER:
        return _Mode(False, True, True, False)
    if m is RenderMode.SUN_SINGLE_SCATTER:
        return _Mode(True, False, False, False)
    raise ValueError(f"unknown mode {m}")


def scatter_loop_plain(
    params: SceneParams,
    static: SceneStatic,
    entry: torch.Tensor,
    dirs: torch.Tensor,
    hit: torch.Tensor,
    ray_ids: torch.Tensor,
    seed_base: int,
    sub_first: int,
    n_samples: int,
    max_steps: Optional[int] = None,
    skip: Optional[int] = None,
) -> PixelMoments:
    """Plain PyTorch version of K4: ``n_samples`` samples per pixel, each
    from box entry ``entry`` [N, 3] (local coordinates) along ``dirs``
    [N, 3], folded in sample order.  Lanes where ``hit`` [N] is false trace
    nothing and return zeros.

    Lockstep over all pixels, one march step per iteration; a lane whose
    sample ends folds it and starts its next sample in the same iteration
    (the kernel's per-thread loop over samples).  ``max_steps`` caps the
    lattice steps each sample advances, sampled or skipped (default
    ``static.max_total_steps``), so that a capped sample stops at the same
    lattice point with or without a skip.  ``skip`` (default
    ``march_ops.skip_mode(static)``): ``SKIP_BLOCK`` takes a step from a
    point in an empty occupancy block ``occupancy_skip_steps`` long (at
    most the steps left before the cap); ``SKIP_CELL`` jumps a sample still
    in flight after a step into an empty cell to the last lattice step
    before the cell's exit face (at most the steps left).  ``sub_first`` is
    an int, or an int64 tensor [N] of per-pixel uint32 bases (K7b's); the
    sums ``sub_first + k`` wrap modulo 2^32.  Differentiable (the
    multi-scatter renderer's plain version, ``render.diff``): under
    autograd each chunk of ``_CHECK_EVERY`` iterations is rematerialized
    in the backward pass; float64 textures are read as float32 (their
    gradients summed in float64)."""
    mode = _mode(static)
    skip = march_ops.skip_mode(static) if skip is None else skip
    march_ops.check_skip(params, static, skip)
    f32 = torch.float32
    dev = entry.device
    n = entry.shape[0]
    cap = static.max_total_steps if max_steps is None else int(max_steps)
    step = static.sample_step
    dm = static.density_multiplier
    dens = params.density_mips[0]
    bbox = params.bbox_size
    ids = rng_ops._u32(ray_ids)
    rr = static.rr_start_depth > 0 and not mode.single
    q = static.rr_survival
    hit = hit.to(torch.bool)
    entry_in = hit & is_in_box(entry, bbox)

    zeros3 = torch.zeros((n, 3), dtype=f32, device=dev)
    w_mean, w_m2 = zeros3.clone(), zeros3.clone()
    w_cnt = torch.zeros((n,), dtype=f32, device=dev)
    steps_total = torch.zeros((n,), dtype=torch.int64, device=dev)
    jumped = torch.zeros((n,), dtype=torch.int64, device=dev)
    bounces = torch.zeros((n,), dtype=torch.int64, device=dev)
    k = torch.zeros((n,), dtype=torch.int64, device=dev)

    # Per-sample state, (re)initialized by ``spawn``.
    seed = torch.zeros((n,), dtype=torch.int64, device=dev)
    pos, dirn, rad = entry.clone(), dirs.clone(), zeros3.clone()
    trans = torch.ones((n,), dtype=f32, device=dev)
    od = torch.zeros((n,), dtype=f32, device=dev)
    weight = torch.ones((n,), dtype=f32, device=dev)
    depth = torch.ones((n,), dtype=torch.int64, device=dev)
    adv_s = torch.zeros((n,), dtype=torch.int64, device=dev)  # lattice steps advanced
    alive = torch.zeros((n,), dtype=torch.bool, device=dev)
    busy = hit & (k < n_samples)  # lane has a sample in flight

    def spawn(mask, state, k):
        seed, pos, dirn, rad, trans, od, weight, depth, adv_s, alive = state
        s = rng_ops.subframe_seed(seed_base, sub_first + k)
        seed = torch.where(mask, s, seed)
        d0 = dirs
        if mode.resample:
            d0 = new_direction(
                params, dirs,
                rng_ops.hash_uniform(s, ids, 0), rng_ops.hash_uniform(s, ids, 1),
            )
        od0 = rng_ops.hash_uniform(s, ids, 0 if mode.single else DRAWS_PER_BOUNCE)
        m3 = mask[:, None]
        return (
            seed,
            torch.where(m3, entry, pos),
            torch.where(m3, d0, dirn),
            torch.where(m3, zeros3, rad),
            torch.where(mask, torch.ones_like(trans), trans),
            torch.where(mask, od0, od),
            torch.where(mask, torch.ones_like(weight), weight),
            torch.where(mask, torch.ones_like(depth), depth),
            torch.where(mask, torch.zeros_like(adv_s), adv_s),
            torch.where(mask, entry_in, alive),
        )

    state = spawn(busy, (seed, pos, dirn, rad, trans, od, weight, depth, adv_s, alive), k)

    def iteration(carry):
        w_mean, w_m2, w_cnt, steps_total, jumped, bounces, k, busy = carry[:8]
        seed, pos, dirn, rad, trans, od, weight, depth, adv_s, alive = carry[8:]
        # A float64 texture is read through a float32 copy made anew each
        # iteration: the same values, and autograd sums its gradient in
        # float64 (the differentiable renderer's plain version).
        p32 = params
        if dens.dtype == torch.float64 or params.inscatter.dtype == torch.float64:
            p32 = params._replace(density_mips=(dens.to(torch.float32),),
                                  inscatter=params.inscatter.to(torch.float32))
        act = alive & (adv_s < cap)
        capped = alive & ~act
        m = None
        if skip == march_ops.SKIP_BLOCK:
            m = march_ops.block_step(params, static, pos, cap - adv_s)
            new = pos + dirn * march_ops.step_length(static, m)[:, None]
        else:
            new = pos + dirn * step
        density = grid_ops.sample_trilinear(p32.density_mips[0], new / bbox) * dm
        tn = trans * torch.exp(-density * step)
        crossed = act & (od > tn)
        back = back_correct_distance(od, tn, density)
        spos = new - dirn * back[:, None]
        inb_s = is_in_box(spos, bbox)
        scat = crossed & inb_s
        chopped = (depth != 1) | mode.chopped_at_depth1
        nee = in_scattering(p32, static, spos, dirn, chopped)
        rad = torch.where(scat[:, None], rad + nee * weight[:, None], rad)
        ctr = depth * DRAWS_PER_BOUNCE
        nd = new_direction(
            params, dirn,
            rng_ops.hash_uniform(seed, ids, ctr + 1),
            rng_ops.hash_uniform(seed, ids, ctr + 2),
        )
        new_depth = torch.where(crossed, depth + 1, depth)
        od_next = rng_ops.hash_uniform(seed, ids, new_depth * DRAWS_PER_BOUNCE)
        exited = act & ~crossed & ~is_in_box(new, bbox)
        sky_exit = exited | (crossed & ~inb_s)
        if mode.sky:
            rad = torch.where(
                sky_exit[:, None],
                rad + sky_exit_radiance(params, static, dirn, depth, weight),
                rad,
            )
        dirn = torch.where(scat[:, None], nd, dirn)
        pos = torch.where(crossed[:, None], spos, torch.where(act[:, None], new, pos))
        trans = torch.where(crossed, torch.ones_like(tn), torch.where(act, tn, trans))
        od = torch.where(crossed, od_next, od)
        if mode.single:
            end = crossed | exited
        else:
            # The oracle's depth test also ends a flight that did not
            # scatter once depth >= max_depth (it only bites at max_depth 1).
            end = sky_exit | (act & (new_depth >= static.max_depth))
        if rr:
            u_rr = rng_ops.hash_uniform(seed, ids, ctr + 3)
            rr_active = crossed & (new_depth >= static.rr_start_depth)
            killed = rr_active & (u_rr >= q)
            weight = torch.where(
                rr_active & ~killed, grid_ops.true_div(weight, q), weight
            )
            end = end | killed
        depth = new_depth
        steps_total = steps_total + act.to(torch.int64)
        bounces = bounces + scat.to(torch.int64)
        if m is not None:
            adv_s = adv_s + torch.where(act, m, torch.zeros_like(m))
            jumped = jumped + torch.where(act, m - 1, torch.zeros_like(m))
        else:
            adv_s = adv_s + act.to(torch.int64)
        if skip == march_ops.SKIP_CELL:
            # A sample still in flight after a step into an empty cell.
            e = march_ops.cell_jump(p32, static, pos, dirn, cap - adv_s)
            go = act & ~crossed & ~end & (e > 0)
            pos = torch.where(go[:, None], pos + dirn * (e * step)[:, None], pos)
            e = torch.where(go, e.to(torch.int64), torch.zeros_like(adv_s))
            adv_s = adv_s + e
            jumped = jumped + e

        # Fold every sample that ended this iteration, in sample order.
        fold = busy & (end | capped | ~alive)
        cnt_new = w_cnt + 1.0
        delta = rad - w_mean
        mean_new = w_mean + delta / torch.clamp(cnt_new, min=1.0)[:, None]
        m2_new = w_m2 + delta * (rad - mean_new)
        w_mean = torch.where(fold[:, None], mean_new, w_mean)
        w_m2 = torch.where(fold[:, None], m2_new, w_m2)
        w_cnt = torch.where(fold, cnt_new, w_cnt)
        k = k + fold.to(torch.int64)
        alive = alive & ~fold
        state = (seed, pos, dirn, rad, trans, od, weight, depth, adv_s, alive)
        respawn = fold & (k < n_samples)
        busy = busy & ~(fold & ~respawn)
        if n_samples > 1:  # with one sample a lane never respawns
            state = spawn(respawn, state, k)
        return (w_mean, w_m2, w_cnt, steps_total, jumped, bounces, k, busy) + state

    def chunk(*carry):
        for _ in range(_CHECK_EVERY):
            carry = iteration(carry)
        return carry

    # Under autograd (the differentiable renderer's plain version) each
    # chunk is rematerialized in the backward pass, as the JAX package's
    # differentiable scan runs its body under jax.checkpoint.
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (dens, params.inscatter, params.light_dir,
                                  params.light_radiance, entry, dirs))
    carry = (w_mean, w_m2, w_cnt, steps_total, jumped, bounces, k, busy) + state
    while bool(carry[7].any()):
        carry = checkpoint(chunk, *carry, use_reentrant=False) if remat else chunk(*carry)
    w_mean, w_m2, w_cnt, steps_total, jumped, bounces = carry[:6]
    return PixelMoments(w_mean, w_m2, w_cnt, steps_total, bounces, jumped)


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
]
#: ``ds_radiance``: ``ds_pathtrace``'s arguments with a pointer to the
#: per-pixel experiment bases in place of ``sub_first``.
RADIANCE_ARGTYPES = _ARGTYPES[:22] + [ctypes.c_void_p] + _ARGTYPES[23:]


class SampleRecords(NamedTuple):
    """A launch's per-sample records, item (sample k, pixel r) at [k, r]."""
    radiance: torch.Tensor  # [n_samples, N, 3] float32
    work: torch.Tensor  # [n_samples, N, 2] int32: steps, in-box scatters


def check_launch(params, entry, dirs, hit, ray_ids, n_samples):
    """The checks of a launch over K4's samples (K4, K7b, K8c) → (N, device,
    density, in-scatter, hit as contiguous uint8, contiguous ray ids)."""
    cuda_build.require_vec3(entry=entry, dirs=dirs)
    n = entry.shape[0]
    dev = entry.device
    dens, insc = params.density_mips[0], params.inscatter
    if dens.dtype != insc.dtype or dens.dtype not in (torch.uint8, torch.float32):
        raise ValueError("density and in-scatter textures must share uint8 or float32")
    if not (dens.is_contiguous() and insc.is_contiguous()):
        raise ValueError("textures must be contiguous")
    if dens.numel() >= 2**31:
        raise ValueError("K4 indexes textures in 32 bits: fewer than 2^31 texels")
    if hit.shape != (n,) or ray_ids.shape != (n,) or ray_ids.dtype != torch.int64:
        raise ValueError("hit must be [N] and ray_ids int64 [N]")
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    ph = params.phase
    check_on(dev, dirs, hit, ray_ids, dens, insc, ph.eval_rows, ph.inv_cdf_rows)
    return n, dev, dens, insc, hit.to(torch.uint8).contiguous(), ray_ids.contiguous()


def launch_consts(static: SceneStatic, max_steps: Optional[int] = None):
    """K4's launch constants from the scene's host values → (consts [17]
    and ground [3] as ctypes float arrays, the mode flags, the step cap)."""
    mode = _mode(static)
    consts = (ctypes.c_float * 17)(
        *static.bbox, static.sample_step, static.density_multiplier,
        *static.light_direction, *static.light_rgb, static.sun_solid_angle_ratio,
        static.sun_cos_half_angle, static.rr_survival, *static.sky_rgb,
    )
    ground = (ctypes.c_float * 3)(*static.ground_rgb)
    flags = (
        int(mode.single) | int(mode.resample) << 1
        | int(mode.chopped_at_depth1) << 2 | int(mode.sky) << 3
    )
    cap = static.max_total_steps if max_steps is None else int(max_steps)
    return consts, ground, flags, cap


def launch_entry(lib, entry_point, argtypes, sub_arg, params, static, entry, dirs, hit,
                 ray_ids, seed_base, n_samples, max_steps, skip=march_ops.SKIP_NONE):
    """Checks the inputs and runs ``entry_point`` of ``lib`` (default the
    package's ``pathtrace`` build): ``ds_pathtrace``, or ``ds_radiance``
    with ``sub_arg`` in the place of ``sub_first``, on the inputs' device
    → (``PixelMoments``, ``SampleRecords``, the device counters [4] int64:
    queue head, march slots; for ``ds_radiance`` also resolve steps and
    crossings resolved).  With a ``skip`` it runs the entry point's
    skipping instantiation, ``<entry_point>_skip``, which also counts the
    lattice steps each pixel jumped.

    Besides the outputs it allocates per-sample records of 20 bytes a
    (pixel, sample), ``N x n_samples`` of them: 10.5 MB for a 512^2 tick of
    2 subframes, 41 MB for the collector's default update (20,480 lanes x
    100 experiments), growing linearly with ``n_samples``."""
    n, dev, dens, insc, hit8, ray_ids = check_launch(params, entry, dirs, hit, ray_ids, n_samples)
    march_ops.check_skip(params, static, skip)
    ph = params.phase
    fn = getattr(lib or cuda_build.load("pathtrace"), entry_point + ("_skip" if skip else ""))
    fn.argtypes = argtypes + (march_ops.SKIP_ARGTYPES if skip else [])
    fn.restype = ctypes.c_int
    jumped = torch.zeros((n,), dtype=torch.int64, device=dev)
    mean = torch.empty((n, 3), dtype=torch.float32, device=dev)
    m2 = torch.empty((n, 3), dtype=torch.float32, device=dev)
    count = torch.empty((n,), dtype=torch.float32, device=dev)
    work = torch.empty((n, 2), dtype=torch.int64, device=dev)
    # Per-sample records (radiance; steps, in-box scatters), folded per
    # pixel in sample order; the queue head and the warps' step slots.
    rec_rad = torch.empty((n_samples, n, 3), dtype=torch.float32, device=dev)
    rec_work = torch.empty((n_samples, n, 2), dtype=torch.int32, device=dev)
    counters = torch.empty((4,), dtype=torch.int64, device=dev)
    consts, ground, flags, cap = launch_consts(static, max_steps)
    nz, ny, nx = static.grid_shape
    cuda_build.check(
        fn(
            cuda_build.ptr(dens), cuda_build.ptr(insc), int(dens.dtype == torch.uint8),
            nx, ny, nz, cuda_build.ptr(ph.eval_rows), ph.eval_rows.shape[0],
            cuda_build.ptr(ph.inv_cdf_rows), ph.inv_cdf_rows.shape[0],
            cuda_build.ptr(entry), cuda_build.ptr(dirs), cuda_build.ptr(hit8),
            cuda_build.ptr(ray_ids), n, consts, ground, cap, static.max_depth,
            static.rr_start_depth, flags, int(seed_base) & 0xFFFFFFFF,
            sub_arg, int(n_samples), cuda_build.ptr(rec_rad),
            cuda_build.ptr(rec_work), cuda_build.ptr(counters), cuda_build.ptr(mean),
            cuda_build.ptr(m2), cuda_build.ptr(count), cuda_build.ptr(work),
            cuda_build.stream_handle(),
            *(march_ops.skip_args(params, static, skip, jumped) if skip else []),
        ),
        f"{entry_point} kernel",
    )
    return (PixelMoments(mean, m2, count, work[:, 0], work[:, 1], jumped),
            SampleRecords(rec_rad, rec_work), counters)


def _launch(params, static, entry, dirs, hit, ray_ids, seed_base, sub_first,
            n_samples, max_steps, lib=None) -> PixelMoments:
    """K4 on the inputs' device (``launch_entry`` with ``ds_pathtrace``, the
    scene's skip).  ``lib``: another library with the same entry points
    (the tests' host build of the kernel's device functions, the
    alternatives ``probes/march_variants.py`` times)."""
    pm, _, counters = launch_entry(lib, "ds_pathtrace", _ARGTYPES,
                                   int(sub_first) & 0xFFFFFFFF, params, static, entry, dirs,
                                   hit, ray_ids, seed_base, n_samples, max_steps,
                                   march_ops.skip_mode(static))
    scatter_loop.launches += 1
    scatter_loop.last_counters = counters[:2]
    return pm


def launch_samples(params, static, entry, dirs, hit, ray_ids, seed_base, sub_first, n_samples,
                   max_steps=None, lib=None) -> SampleRecords:
    """K4 on the inputs' device for its per-sample records (item (sample
    k, pixel r) at [k, r]; a pixel without a box hit has none: its rows are
    left unwritten).  The differentiable renderer's forward: no skip,
    whatever the scene says (K8c replays these paths on the plain lattice,
    as the JAX package's differentiable loop marches it)."""
    _, rec, counters = launch_entry(lib, "ds_pathtrace", _ARGTYPES, int(sub_first) & 0xFFFFFFFF,
                                    params, static, entry, dirs, hit, ray_ids, seed_base,
                                    n_samples, max_steps)
    scatter_loop.launches += 1
    scatter_loop.last_counters = counters[:2]
    return rec


def scatter_loop(
    params: SceneParams,
    static: SceneStatic,
    entry: torch.Tensor,
    dirs: torch.Tensor,
    hit: torch.Tensor,
    ray_ids: torch.Tensor,
    seed_base: int,
    sub_first: int,
    n_samples: int,
    max_steps: Optional[int] = None,
) -> PixelMoments:
    """K4's wrapper: the kernel for CUDA tensors, ``scatter_loop_plain``
    for CPU tensors (same signature and values), with the scene's skip
    (``march_ops.skip_mode``)."""
    if entry.is_cuda:
        return _launch(params, static, entry, dirs, hit, ray_ids, seed_base,
                       sub_first, n_samples, max_steps)
    return scatter_loop_plain(params, static, entry, dirs, hit, ray_ids,
                              seed_base, sub_first, n_samples, max_steps)


#: Kernel launches so far (counted where K4 is launched, nowhere else).
scatter_loop.launches = 0
#: The last launch's device counters [2] int64: work items taken from the
#: queue (at least N x n_samples) and the warps' step slots, the lookahead's
#: steps for each loop iteration of a warp (SIMT efficiency = steps / (32 x
#: step slots)).
scatter_loop.last_counters = None


def _default_ids(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def trace_hit_radiance(
    params: SceneParams,
    static: SceneStatic,
    entry_pos: torch.Tensor,
    directions: torch.Tensor,
    hit: torch.Tensor,
    seed: int,
    ray_ids: torch.Tensor,
) -> torch.Tensor:
    """One sample of radiance [N, 3] for rays entering the box at
    ``entry_pos`` (local coordinates), per the configured mode, with the
    sample seed ``seed``; 0 where ``hit`` is false.  One K4 launch (on CPU
    tensors its plain version)."""
    return scatter_loop(
        params, static, entry_pos, directions, hit, ray_ids, seed, 0, 1
    ).mean


def _scene_device(device, params: SceneParams, *tensors) -> torch.device:
    dev = resolve_device(device)
    check_on(dev, params.density_mips[0], *tensors)
    return dev


def render_subframe(
    params: SceneParams,
    static: SceneStatic,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed_base: int,
    subframe_id: int,
    ray_ids: Optional[torch.Tensor] = None,
    device="cuda",
) -> torch.Tensor:
    """One Monte-Carlo sample per ray → radiance [N, 3] (one launch of
    pathTracingCamera.cu): intersect the box, shade misses with sun and
    sky, trace hits with the seed ``seed_base ^ (subframe_id *
    0x9E3779B1)``."""
    dev = _scene_device(device, params, origins, directions)
    n = origins.shape[0]
    if ray_ids is None:
        ray_ids = _default_ids(n, dev)
    seed = rng_ops.subframe_seed(seed_base, subframe_id)
    hit, t_hit = camera_ops.intersect_box(origins, directions, static, params.bbox_size)
    entry = camera_ops.entry_points(origins, directions, t_hit, params.bbox_size)
    rad = trace_hit_radiance(params, static, entry, directions, hit, seed, ray_ids)
    miss = camera_ops.miss_radiance(params, static, directions)
    return torch.where(hit[:, None], rad, miss)


def trace_tick_moments(
    params: SceneParams,
    static: SceneStatic,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed_base: int,
    sub0: int,
    n_subframes: int,
    ray_ids: Optional[torch.Tensor] = None,
    device="cuda",
    max_steps: Optional[int] = None,
):
    """Per-pixel Welford moments ``(mean [N, 3], m2 [N, 3], count [N])`` of
    ``n_subframes`` samples, those of subframes ``sub0 + 1 ..  sub0 +
    n_subframes``: one K4 launch over every pixel.  Box-missing pixels
    shade the deterministic miss program every subframe (mean = miss,
    m2 = 0, count = n_subframes).  Per-sample values equal
    ``render_subframe``'s; only the summation order differs."""
    dev = _scene_device(device, params, origins, directions)
    n = origins.shape[0]
    if ray_ids is None:
        ray_ids = _default_ids(n, dev)
    hit, t_hit = camera_ops.intersect_box(origins, directions, static, params.bbox_size)
    entry = camera_ops.entry_points(origins, directions, t_hit, params.bbox_size)
    pm = scatter_loop(
        params, static, entry, directions, hit, ray_ids, seed_base, sub0 + 1,
        n_subframes, max_steps,
    )
    miss = camera_ops.miss_radiance(params, static, directions)
    mean = torch.where(hit[:, None], pm.mean, miss)
    m2 = torch.where(hit[:, None], pm.m2, torch.zeros_like(pm.m2))
    cnt = torch.where(hit, pm.count, torch.full_like(pm.count, float(n_subframes)))
    return mean, m2, cnt
