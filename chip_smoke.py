#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``deepestscatter_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, one output line each:

1. ``env`` / ``build``: the card, torch and CUDA versions; the kernels
   built from ``deepestscatter_tpu_torch/csrc`` (one nvcc per source, in
   parallel) with their ptxas register reports.
2. ``K3`` / ``K1`` / ``K2``: each kernel against its plain PyTorch version
   at the operating point's shapes, with the tolerance it must meet, its
   time (CUDA events), the plain version's time and the work counts its
   bound is computed from.  K3 must equal its plain version bitwise.
3. ``K4``: the path tracer's bounce loop against its plain version on the
   256^3 scene: a two-subframe tick over the whole 512^2 frame (the main
   path's shapes), and one subframe per render mode over a strided subset
   of 16,384 pixels, with the work counts (paths, steps, bounces); step
   counts must be equal on every pixel.  Its SIMT efficiency (steps over
   the step slots of the warps' loop iterations, from the kernel's
   counters) beside that of one thread per pixel (pixels grouped by 32,
   each group as long as its longest pixel).
4. ``frame``: the RPNN neural frame driven the way a user would drive it
   (build the scene, bake the in-scatter field, init ``DisneyModel`` from
   ``torch.Generator(566)``, render) at the reference's ``renderCloud``
   point: the 256^3 procedural cumulus of seed 11, 2000 m, uint8 textures,
   512 x 256.  Kernel launch counts are set to 0 just before each path
   (the neural frame, the path tracer, the probe) and read just after;
   every kernel must have launched on its path.  Frames must be finite,
   deterministic per seed and different across seeds.
5. ``frame vs plain``: the frame against one computed with every kernel's
   plain version, on every pixel whose scatter flag agrees.
6. ``profile``: the frame's device time by kernel (torch.profiler).
7. ``PT``: ``ProgressiveRenderer`` driven the way a user would drive it
   (build, bake, ticks of 2 subframes at 512^2, ``run()`` with a small
   ``ProgressiveConfig``, ``display_image``) at 256^3 and 64^3: Mrays/s,
   steps/s, image mean, launches, peak memory, and the device time of 10
   ticks by kernel (torch.profiler).  The image mean must lie
   in (0.1, 10), be finite, repeat for the same seed and differ across
   seeds.
8. ``P1`` / ``P2``: the row-gather probe's entry point
   (``probes.gather.main``) at the Pallas probe's cases, each kernel's sums
   equal to its plain version's; then P1 at a table the size of the 256^3
   texture beside K4's step rate (the path tracer's gather ceiling).

Then the card's ``name, power.limit`` line, the ``{"kernels": [...]}``
line, and as the last line ``{"ok": true, "device": {...}}``.  A failed
check exits 1 before the last line; without a CUDA device the run exits 1
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

#: Published H100 SXM peaks (dense): HBM bytes/s and float32 operations/s
#: outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: Operations counted per march step (position update, texture coordinates,
#: trilinear index math and weights, eight dequantized taps, attenuation,
#: loop tests), per K1 ray (AABB clip, hash, NEE epilogue), and per K2
#: stencil sample (offset, one trilinear, fade) plus per second mip level.
K1_OPS_PER_STEP = 74
K1_OPS_PER_RAY = 130
#: K3, the work any implementation must do: per voxel-step the x position
#: and coordinate, the x cell and weights, eight weight products, eight
#: taps summed, the attenuation and exp, the early-out test; per row-step
#: (the same for every voxel of an x-row) s, the y and z positions,
#: coordinates, cells and weights, the four (wz * wy) products and row
#: offsets.  (The first design's bound counted 70 a voxel-step for all of
#: it; the K3 line prints that bound too.)
K3_OPS_PER_VOXEL_STEP = 45
K3_OPS_PER_ROW_STEP = 45
K2_OPS_PER_SAMPLE = 103
K2_OPS_PER_HI_LEVEL = 56
#: K4: per march step (K1's step work plus the in-box test), per in-box
#: scatter (back-correction, NEE with the in-scatter trilinear and the
#: phase lerp, two hashes and the inverse-CDF / azimuth / frame rotation of
#: the new direction, the next free-flight hash), per sample (seed, first
#: hash, Welford fold).
K4_OPS_PER_STEP = 80
K4_OPS_PER_BOUNCE = 270
K4_OPS_PER_SAMPLE = 35

SEED_WEIGHTS = 566
WIDTH, HEIGHT = 512, 256
#: The path tracer's operating point (bench.py): 512^2, 2 subframes a tick.
PT_SIZE = 512
PT_SUBFRAMES = 2
PT_SEED = 5
PT_SECONDS = 3.0
K4_SUBSET_STRIDE = 16  # 16,384 of the 262,144 pixels
#: K3's and K4's times before their redesign, quoted from PERF.md (this
#: script on an H100 80GB HBM3 at 700 W) on the human-readable lines only.
PREV_MS = {"K3": 61.05, "K4": 6.105}


class Failed(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    if out.returncode != 0 or not out.stdout.strip():
        return "nvidia-smi unavailable"
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def kernel_row(name, source, replaces, err, ms, plain_ms, n_bytes, n_ops,
               library_ms=None) -> dict:
    """One entry of the kernels line; the bound is the larger of the bytes
    over the HBM rate and the operations over the float32 peak."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations", library_ms=library_ms)


def phase_build(cuda_build) -> None:
    t0 = time.time()
    secs = cuda_build.build()
    ptxas = {}
    keep = ("entry function", "spill", "Used")
    for name in cuda_build.SOURCES:
        log = cuda_build.BUILD_DIR / f"{name}.log"
        lines = log.read_text().splitlines() if log.is_file() else []
        ptxas[name] = [ln.split("ptxas info    : ")[-1].strip() for ln in lines
                       if any(k in ln for k in keep)]
    print(f"build: {time.time() - t0:.1f}s per-source={json.dumps({k: round(v, 1) for k, v in secs.items()})} "
          f"ptxas={json.dumps(ptxas)}", flush=True)


def phase_k3(ins_ops, params, static) -> dict:
    """K3 against its plain version over the whole grid: bitwise."""
    k3 = ins_ops.sun_transmittance(params, static)
    p3, steps = ins_ops.sun_transmittance_plain(params, static, return_steps=True)
    err = (k3 - p3).abs().max().item()
    q = lambda t: torch.floor(t * 255.0) / 255.0  # noqa: E731
    qmis = (q(k3) != q(p3)).float().mean().item()
    ms = time_ms(lambda: ins_ops.sun_transmittance(params, static), 3)
    plain = host_ms(lambda: ins_ops.sun_transmittance_plain(params, static))
    v, n_steps = k3.numel(), int(steps.sum().item())
    # The row-steps this data needs: each x-row marches as long as its
    # longest voxel.
    row_steps = int(steps.reshape(-1, static.grid_shape[2]).amax(dim=1).sum().item())
    print(f"K3 bake: voxels={v} steps={n_steps} row_steps={row_steps} max_abs_err={err:.3g} (tol 0) "
          f"quantized_mismatch={qmis:.3g} ms={ms:.3f} before_redesign_ms(PERF.md)={PREV_MS['K3']} "
          f"plain_ms={plain:.1f} "
          f"bound_ms(at 70 a voxel-step)={n_steps * 70 / F32_OPS_PER_S * 1e3:.3f}", flush=True)
    require(err == 0.0, "K3 disagrees with its plain version")
    return kernel_row("K3 inscatter bake", "deepestscatter_tpu_torch/csrc/inscatter.cu",
                      "deepestscatter_tpu/render/inscatter.py:38", err, ms, plain,
                      v * params.density_mips[0].element_size() + 4 * v,
                      n_steps * K3_OPS_PER_VOXEL_STEP + row_steps * K3_OPS_PER_ROW_STEP)


def phase_k1(march_ops, params, static, entry, dirs, ids):
    """K1 against its plain version on the frame's box hits (pass 1) and
    its T < 1 rays (pass 2).  Tolerance: T within 1e-5; ok flags equal on
    >= 99.5 % of rays; on rays both flag, positions within 1e-4 and direct
    light within 1e-3 of the largest, on >= 99.5 %.  Returns the kernel
    row and the pass-2 result (the frame's shading points)."""
    k1 = march_ops.camera_march(params, static, entry, dirs)
    # Pass 1 of the plain version is this march at od = 0; its step counts
    # are the work of both passes (liveness is geometric, so pass 2 takes
    # the same steps on the rays it marches).
    ev1 = march_ops.next_scattering_event(
        params, static, torch.zeros_like(k1.transmittance), entry, dirs)
    err = (k1.transmittance - ev1.transmittance).abs().max().item()
    sel = torch.nonzero(ev1.transmittance < 1.0).flatten()
    e2, d2 = entry[sel].contiguous(), dirs[sel].contiguous()
    t2, ids2 = ev1.transmittance[sel].contiguous(), ids[sel].contiguous()
    k2 = march_ops.camera_march(params, static, e2, d2, 1, ids2, t2)
    p2 = march_ops.camera_march_plain(params, static, e2, d2, 1, ids2, t2)
    agree = (k2.ok == p2.ok).float().mean().item()
    both = k2.ok & p2.ok
    pos_ok = ((k2.scatter_pos - p2.scatter_pos)[both].abs().amax(dim=-1) <= 1e-4).float().mean().item()
    dmax = p2.direct.abs().max().item()
    direct_ok = ((k2.direct - p2.direct)[both].abs().amax(dim=-1) <= 1e-3 * dmax).float().mean().item()
    ms = time_ms(lambda: (march_ops.camera_march(params, static, entry, dirs),
                          march_ops.camera_march(params, static, e2, d2, 1, ids2, t2)), 5)
    plain = host_ms(lambda: (march_ops.camera_march_plain(params, static, entry, dirs),
                             march_ops.camera_march_plain(params, static, e2, d2, 1, ids2, t2)))
    n1, n2 = entry.shape[0], e2.shape[0]
    s1, s2 = int(ev1.steps.sum().item()), int(ev1.steps[sel].sum().item())
    print(f"K1 march: pass1_rays={n1} pass2_rays={n2} steps={s1}+{s2} T_max_abs_err={err:.3g} (tol 1e-5) "
          f"ok_agree={agree:.6f} pos_within_1e-4={pos_ok:.6f} direct_within_1e-3max={direct_ok:.6f} "
          f"(tol 0.995) ms(pass1+pass2)={ms:.3f} plain_ms={plain:.1f}", flush=True)
    require(err <= 1e-5 and min(agree, pos_ok, direct_ok) >= 0.995,
            "K1 disagrees with its plain version")
    tex = params.density_mips[0].numel() * params.density_mips[0].element_size()
    n_bytes = 2 * tex + params.phase.eval_rows.numel() * 4 + n1 * 28 + n2 * 65
    row = kernel_row("K1 camera march + NEE", "deepestscatter_tpu_torch/csrc/march.cu",
                     "deepestscatter_tpu/ops/march.py:100", err, ms, plain, n_bytes,
                     (s1 + s2) * K1_OPS_PER_STEP + (n1 + n2) * K1_OPS_PER_RAY)
    return row, k2, d2


def phase_k2(desc_ops, grid_ops, params, static, pts, dirs) -> dict:
    """K2 against its plain version on the frame's shading points, in one
    launch.  Tolerance: 1e-5 (descriptors in [0, 1], omega in [0, pi])."""
    kd = desc_ops.network_inputs(params, static, pts, dirs)
    pd = desc_ops.network_inputs_plain(params, static, pts, dirs)
    err = (kd - pd).abs().max().item()
    ms = time_ms(lambda: desc_ops.network_inputs(params, static, pts, dirs), 5)
    plain = host_ms(lambda: desc_ops.network_inputs_plain(params, static, pts, dirs))
    m = pts.shape[0]
    print(f"K2 descriptor: points={m} out={tuple(kd.shape)} max_abs_err={err:.3g} (tol 1e-5) "
          f"ms={ms:.3f} plain_ms={plain:.1f}", flush=True)
    require(err <= 1e-5, "K2 disagrees with its plain version")
    layers = desc_ops.DISNEY_LAYERS
    n_hi = sum(1 for _, _, lod in desc_ops.layer_plan(static, layers)
               if grid_ops.mip_lerp_levels(static.n_mips, lod)[4])
    n_ops = m * 225 * (layers * K2_OPS_PER_SAMPLE + n_hi * K2_OPS_PER_HI_LEVEL)
    n_bytes = params.mip_flat.numel() * params.mip_flat.element_size() + m * 24 + kd.numel() * 4
    return kernel_row("K2 descriptor stencil", "deepestscatter_tpu_torch/csrc/descriptor.cu",
                      "deepestscatter_tpu/ops/descriptor.py:92", err, ms, plain, n_bytes, n_ops)


def plain_frame(params, static, model, basis, seed):
    """The frame computed with every kernel's plain version on the card →
    (image, scatter flags)."""
    from deepestscatter_tpu_torch.ops import descriptor as desc_ops
    from deepestscatter_tpu_torch.ops import march as march_ops
    from deepestscatter_tpu_torch.render import camera as cam
    from deepestscatter_tpu_torch.render import neural

    dev = params.bbox_size.device
    o, d = cam.generate_rays(basis, WIDTH, HEIGHT, dev)
    n = o.shape[0]
    hit, t_hit = cam.intersect_box(o, d, static, params.bbox_size)
    entry = cam.entry_points(o, d, t_hit, params.bbox_size)
    trans = torch.ones(n, device=dev)
    idx = torch.nonzero(hit).flatten()
    trans[idx] = march_ops.camera_march_plain(params, static, entry[idx], d[idx]).transmittance
    idx2 = torch.nonzero(hit & (trans < 1.0)).flatten()
    m2 = march_ops.camera_march_plain(
        params, static, entry[idx2], d[idx2], seed, idx2, trans[idx2]
    )
    pos = torch.zeros(n, 3, device=dev)
    ok = torch.zeros(n, dtype=torch.bool, device=dev)
    direct = torch.zeros(n, 3, device=dev)
    pos[idx2], ok[idx2], direct[idx2] = m2.scatter_pos, m2.ok, m2.direct
    pred = torch.zeros(n, device=dev)
    idx3 = torch.nonzero(ok).flatten()
    with torch.inference_mode():
        pred[idx3] = model(desc_ops.network_inputs_plain(params, static, pos[idx3], d[idx3]))[:, 0]
    cs = neural.ConditionalScatter(trans, pos, ok, direct)
    miss = cam.miss_radiance(params, static, d)
    return neural.composite(pred, cs, miss, hit).reshape(HEIGHT, WIDTH, 3), ok


def phase_profile(label: str, fn, unprofiled_ms: float) -> None:
    """Device time of ``fn()`` by kernel, against ``unprofiled_ms`` (the
    same work timed without the profiler).  Diagnostic only: a profiler
    that cannot trace the card prints ``unavailable`` and the run goes on."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # Device-side events only: a CPU op's self device time repeats its
        # kernels' time.
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    except (RuntimeError, AttributeError) as exc:
        print(f"{label}: unavailable ({exc})", flush=True)
        return
    evs.sort(key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    top = [[e.key[:70], round(e.self_device_time_total / 1e3, 3), e.count] for e in evs[:12]]
    print(f"{label}: kernels_ms={dev_ms:.3f} profiled_wall_ms={wall:.3f} unprofiled_ms={unprofiled_ms:.3f} "
          f"idle_share_vs_unprofiled={1 - dev_ms / unprofiled_ms:.3f} top={json.dumps(top)}",
          flush=True)


def pt_rays(cam, params, static, dev):
    """The path tracer's 512^2 rays: (entry, dirs, hit, ray ids)."""
    from deepestscatter_tpu_torch import config

    basis = cam.camera_basis(config.CameraConfig(width=PT_SIZE, height=PT_SIZE))
    o, d = cam.generate_rays(basis, PT_SIZE, PT_SIZE, params.bbox_size.device)
    hit, t_hit = cam.intersect_box(o, d, static, params.bbox_size)
    entry = cam.entry_points(o, d, t_hit, params.bbox_size)
    return entry, d, hit, torch.arange(o.shape[0], device=d.device)


def k4_compare(pt, params, static, args):
    """K4 and its plain version on the same inputs → (kernel result, plain
    result, plain host ms, max abs err, share of pixels with equal step
    counts).  Tolerance: step and scatter counts equal on every pixel;
    mean within 1e-5 and m2 within 1e-4 of their largest values."""
    k = pt.scatter_loop(params, static, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = pt.scatter_loop_plain(params, static, *args)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    same = k.steps == r.steps
    share = same.float().mean().item()
    err = max((k.mean - r.mean).abs().max().item(), (k.m2 - r.m2).abs().max().item())
    ok = torch.equal(k.count, r.count) and share == 1.0 and torch.equal(k.bounces, r.bounces)
    for a, b, tol in ((k.mean, r.mean, 1e-5), (k.m2, r.m2, 1e-4)):
        ok = ok and (a - b)[same].abs().max().item() <= tol * (b.abs().max().item() + 1e-12)
    require(ok, f"K4 disagrees with its plain version (steps equal on {share:.6f})")
    return k, r, plain, err, share


def simt_per_pixel(steps: torch.Tensor) -> float:
    """SIMT efficiency of one thread per pixel: pixels in groups of 32
    (warps), each group marching as long as its longest pixel."""
    s = steps.to(torch.float64)
    pad = (-s.numel()) % 32
    s = torch.cat([s, s.new_zeros(pad)]).reshape(-1, 32)
    return float(s.sum() / (32.0 * s.amax(dim=1).sum()))


def phase_k4(pt, cam, modes, params, static) -> dict:
    """K4 against its plain version on the 256^3 scene: the main path's
    two-subframe tick over all 512^2 pixels, then one subframe per render
    mode over a strided subset.  Returns the kernel row."""
    entry, d, hit, ids = pt_rays(cam, params, static, params.bbox_size.device)
    args = (entry, d, hit, ids, PT_SEED, 1, PT_SUBFRAMES)
    k, r, plain, err, share = k4_compare(pt, params, static, args)
    items, slots = (int(v) for v in pt.scatter_loop.last_counters.tolist())
    n, n_hit = entry.shape[0], int(hit.sum().item())
    steps, bounces = int(r.steps.sum().item()), int(r.bounces.sum().item())
    simt = steps / (32.0 * slots)
    ms = time_ms(lambda: pt.scatter_loop(params, static, *args), 5)
    print(f"K4 bounce loop: tick pixels={n} subframes={PT_SUBFRAMES} paths={n_hit * PT_SUBFRAMES} "
          f"steps={steps} bounces={bounces} max_pixel_steps={int(r.steps.max().item())} "
          f"steps_equal={share:.6f} (tol 1) max_abs_err={err:.3g} (tol mean 1e-5, m2 1e-4 of max) "
          f"ms={ms:.3f} before_redesign_ms(PERF.md)={PREV_MS['K4']} plain_ms={plain:.1f}", flush=True)
    print(f"K4 SIMT: items_taken={items} warp_step_slots={slots} "
          f"simt_efficiency={simt:.4f} (steps / (32 x step slots)) "
          f"one_thread_per_pixel={simt_per_pixel(r.steps):.4f} (steps / (32 x longest pixel) by "
          f"groups of 32 pixels)", flush=True)
    require(items >= n * PT_SUBFRAMES, "K4's queue handed out fewer items than the tick has")
    sub = torch.arange(0, n, K4_SUBSET_STRIDE, device=entry.device)
    sargs = (entry[sub].contiguous(), d[sub].contiguous(), hit[sub].contiguous(),
             ids[sub].contiguous(), PT_SEED, 3, 1)
    for mode in modes:
        st = dataclasses.replace(static, mode=mode)
        _, rm, plain_m, err_m, share_m = k4_compare(pt, params, st, sargs)
        err = max(err, err_m)
        print(f"K4 {mode.name}: pixels={sub.numel()} paths={int(sargs[2].sum().item())} "
              f"steps={int(rm.steps.sum().item())} bounces={int(rm.bounces.sum().item())} "
              f"steps_equal={share_m:.6f} max_abs_err={err_m:.3g} plain_ms={plain_m:.1f}", flush=True)
    tex = 2 * params.density_mips[0].numel() * params.density_mips[0].element_size()
    tables = (params.phase.eval_rows.numel() + params.phase.inv_cdf_rows.numel()) * 4
    n_bytes = tex + tables + n * (12 + 12 + 1 + 8) + n * (12 + 12 + 4 + 16)
    n_ops = (steps * K4_OPS_PER_STEP + bounces * K4_OPS_PER_BOUNCE
             + n_hit * PT_SUBFRAMES * K4_OPS_PER_SAMPLE)
    return kernel_row("K4 path-trace bounce loop", "deepestscatter_tpu_torch/csrc/pathtrace.cu",
                      "deepestscatter_tpu/render/pathtracer.py:671", err, ms, plain, n_bytes, n_ops)


def pt_scene(port, config, procedural, res, dev):
    """bench.py's path-tracing point: cumulus of seed 11 at ``res``^3, 2000 m,
    uint8 textures, all-scatter, max_depth 2000, step 1/512, 512^2."""
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=PT_SIZE, height=PT_SIZE),
        rendering=config.CloudRendering(march_dtype="uint8"),
        progressive=config.ProgressiveConfig(subframes_per_tick=PT_SUBFRAMES),
    )
    params, static = port.build_scene(cfg, procedural.cumulus(resolution=res, seed=11), device=dev)
    return cfg, port.with_baked_inscatter(params, static, device=dev), static


def phase_pt(port, config, procedural, pt, prog, res, dev) -> dict:
    """The progressive path tracer at one grid size, as a user drives it.
    Returns the scene and the mean seconds per tick."""
    k4_before = pt.scatter_loop.launches
    torch.cuda.synchronize()
    t0 = time.time()
    cfg, params, static = pt_scene(port, config, procedural, res, dev)
    r = port.ProgressiveRenderer(cfg, params, static, seed=PT_SEED, device=dev)
    r.tick()  # warm-up
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    first_mean = float(r.state.mean.mean().item())
    torch.cuda.reset_peak_memory_stats()
    times = []
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < PT_SECONDS or len(times) < 5:
        t0 = time.perf_counter()
        r.tick()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    hdr = r.hdr_image()
    mean = float(hdr.mean())
    n_prof = 10

    def ticks():
        for _ in range(n_prof):
            r.tick()

    phase_profile(f"PT {res}^3 profile ({n_prof} ticks)", ticks, n_prof * 1e3 * float(np.mean(times)))
    # Determinism: the same seed repeats the first tick, another seed differs.
    same = port.ProgressiveRenderer(cfg, params, static, seed=PT_SEED, device=dev)
    same.tick()
    other = port.ProgressiveRenderer(cfg, params, static, seed=PT_SEED + 1, device=dev)
    other.tick()
    same_mean = float(same.state.mean.mean().item())
    other_mean = float(other.state.mean.mean().item())
    # The convergence gate and the display path, with a small configuration.
    small = dataclasses.replace(cfg, progressive=config.ProgressiveConfig(
        subframes_per_tick=PT_SUBFRAMES, min_subframes=4, max_subframes=8))
    short = port.ProgressiveRenderer(small, params, static, seed=PT_SEED, device=dev)
    short_hdr = short.run()
    disp = short.display_image()
    unconverged = int(prog.unconverged_count(short.state, small.progressive))
    tick_s = float(np.mean(times))
    rays = PT_SIZE * PT_SIZE * PT_SUBFRAMES
    print(f"PT {res}^3: setup(build+bake+warm tick)={setup_s:.2f}s ticks={len(times)} "
          f"s_per_tick_mean={tick_s:.6f} min={min(times):.6f} Mrays_per_s={rays / tick_s / 1e6:.3f} "
          f"K4_launches={pt.scatter_loop.launches - k4_before} image_mean={mean:.6f} "
          f"first_tick_mean={first_mean:.6f} same_seed_mean={same_mean:.6f} other_seed_mean={other_mean:.6f} "
          f"subframes={r.state.subframe_id} peak_mem_mb={peak / 2**20:.1f} "
          f"run(min 4, max 8): subframes={short.state.subframe_id} unconverged={unconverged} "
          f"display={disp.shape} {disp.dtype}", flush=True)
    require(0.1 < mean < 10.0, f"PT {res}^3 image mean {mean} outside (0.1, 10)")
    require(bool(np.isfinite(hdr).all()) and bool(np.isfinite(short_hdr).all()),
            f"PT {res}^3 image has a non-finite pixel")
    require(same_mean == first_mean, f"PT {res}^3: the same seed gave a different mean")
    require(other_mean != first_mean, f"PT {res}^3: two seeds gave the same mean")
    require(disp.shape == (PT_SIZE, PT_SIZE, 3) and disp.dtype == np.uint8
            and short.state.subframe_id >= 4, f"PT {res}^3: run()/display_image failed")
    return dict(tick_s=tick_s, params=params, static=static)


def pt_work(pt, cam, res, run) -> float:
    """Steps of one tick of the path tracer's scene (the kernel's own step
    counts, from one launch outside the counted path) → steps/s."""
    params, static = run["params"], run["static"]
    entry, d, hit, ids = pt_rays(cam, params, static, params.bbox_size.device)
    work = pt.scatter_loop(params, static, entry, d, hit, ids, PT_SEED, 1, PT_SUBFRAMES)
    steps, bounces = int(work.steps.sum().item()), int(work.bounces.sum().item())
    print(f"PT {res}^3 work: steps_per_tick={steps} bounces_per_tick={bounces} "
          f"paths_per_tick={int(hit.sum().item()) * PT_SUBFRAMES} "
          f"steps_per_s={steps / run['tick_s']:.6g}", flush=True)
    return steps / run["tick_s"]


def phase_probe(gather, k4_steps_per_s: float):
    """The probe's entry point, counted; returns the P1 and P2 rows."""
    for f in (gather.per_lane, gather.coalesced):
        f.launches = 0
    report = gather.main([])
    launches = {"P1": gather.per_lane.launches, "P2": gather.coalesced.launches}
    print(f"P1/P2 probe: cases={len(report['results'])} launches={json.dumps(launches)} "
          f"(sums equal to the plain versions in every case)", flush=True)
    require(all(n > 0 for n in launches.values()), f"a probe kernel never launched: {launches}")
    by = {(r["kind"], r["nrows"]): r for r in report["results"]}
    rows = {}
    for key, kind, name, fn, line in (
        ("P1", "per_lane", "P1 row-gather probe, per lane", "_per_lane_kernel", 39),
        ("P2", "coalesced_32", "P2 row-gather probe, coalesced runs of 32", "_coalesced_kernel", 79),
    ):
        r = by[(kind, gather.CASES[-1][0])]
        rows[key] = dict(name=name, route="cuda", source="deepestscatter_tpu_torch/csrc/gather_probe.cu",
                         replaces=f"tools/pallas_gather_probe.py:{line}", max_abs_err=r["max_abs_err"],
                         ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by="bytes",
                         library_ms=r["library_ms"], launches=launches[key])
    texture_rows = (1 << 24) // 16
    ceil = gather.measure("per_lane", texture_rows, 16, 1 << 18)
    print(f"PT gather ceiling: P1 over a 16 MiB table (the 256^3 uint8 density texture), 16-B rows: "
          f"{ceil['mrows_per_s']:.1f} Mrows/s; K4 at 256^3: {k4_steps_per_s / 1e6:.1f} Msteps/s "
          f"(8 texel reads a step)", flush=True)
    return rows


def run() -> dict:
    """All phases; returns the kernel rows with their launch counts."""
    import deepestscatter_tpu_torch as port
    from deepestscatter_tpu_torch import config, cuda_build
    from deepestscatter_tpu_torch.data import procedural
    from deepestscatter_tpu_torch.models.rpnn import init_disney_model
    from deepestscatter_tpu_torch.ops import descriptor as desc_ops
    from deepestscatter_tpu_torch.ops import grid as grid_ops
    from deepestscatter_tpu_torch.ops import march as march_ops
    from deepestscatter_tpu_torch.probes import gather
    from deepestscatter_tpu_torch.render import camera as cam
    from deepestscatter_tpu_torch.render import inscatter as ins_ops
    from deepestscatter_tpu_torch.render import neural
    from deepestscatter_tpu_torch.render import pathtracer as pt
    from deepestscatter_tpu_torch.render import progressive as prog

    dev = torch.device("cuda")
    print(f"env: card={card_line()!r} torch={torch.__version__} cuda={torch.version.cuda} "
          f"device={torch.cuda.get_device_name(0)!r} count={torch.cuda.device_count()}", flush=True)
    phase_build(cuda_build)

    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=WIDTH, height=HEIGHT),
        rendering=config.CloudRendering(march_dtype="uint8"),
    )
    basis = cam.camera_basis(cfg.camera)
    t0 = time.time()
    density = procedural.cumulus(resolution=256, seed=11)
    params, static = port.build_scene(cfg, density, device=dev)
    print(f"scene: grid={static.grid_shape} mips={static.n_mips} "
          f"aabb={[round(v, 4) for v in static.cloud_aabb]} {time.time() - t0:.1f}s", flush=True)

    # -- kernels against their plain versions ------------------------------
    rows = {"K3": phase_k3(ins_ops, params, static)}
    baked = port.with_baked_inscatter(params, static, device=dev)
    o, d = cam.generate_rays(basis, WIDTH, HEIGHT, dev)
    hit, t_hit = cam.intersect_box(o, d, static, baked.bbox_size)
    idx = torch.nonzero(hit).flatten()
    entry = cam.entry_points(o, d, t_hit, baked.bbox_size)[idx].contiguous()
    rows["K1"], scat, scat_dirs = phase_k1(
        march_ops, baked, static, entry, d[idx].contiguous(), idx)
    rows["K2"] = phase_k2(desc_ops, grid_ops, baked, static,
                          scat.scatter_pos[scat.ok].contiguous(),
                          scat_dirs[scat.ok].contiguous())
    del scat, scat_dirs
    rows["K4"] = phase_k4(pt, cam, list(config.RenderMode), baked, static)
    del baked

    # -- the neural frame's main path, counted ------------------------------
    counters = {"K1": march_ops.camera_march, "K2": desc_ops.network_inputs,
                "K3": ins_ops.sun_transmittance}
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    params, static = port.build_scene(cfg, density, device=dev)
    params = port.with_baked_inscatter(params, static, device=dev)
    model = init_disney_model(SEED_WEIGHTS, device=dev)
    renderer = port.DisneyRenderer(model, device=dev)
    warm = renderer.render_frame(params, static, WIDTH, HEIGHT, basis, seed=1)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    frames, times = [], []
    for s in range(2, 8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames.append(renderer.render_frame(params, static, WIDTH, HEIGHT, basis, seed=s))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    launches = {k: f.launches for k, f in counters.items()}
    n_rays, n_hit, n_scat = renderer.last_counts
    again = renderer.render_frame(params, static, WIDTH, HEIGHT, basis, seed=2)
    frame_ms = float(np.mean(times))
    print(f"frame: setup(build+bake+init+warm)={setup_s:.2f}s frames={len(times)} "
          f"ms_per_frame_mean={frame_ms:.3f} ms_min={min(times):.3f} "
          f"ms_all={[round(t, 3) for t in times]} frac_hit={n_hit / n_rays:.4f} "
          f"frac_scattered={n_scat / n_rays:.4f} peak_mem_mb={peak / 2**20:.1f} "
          f"launches={json.dumps(launches)} (per frame: K1 2, K2 {-(-n_scat // renderer.TILE)}; "
          f"K3 once per scene)", flush=True)
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    require(all(img.shape == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(img).all())
                for img in [warm] + frames), "a frame is not finite or has the wrong shape")
    require(torch.equal(again, frames[0]), "the same seed gave a different frame")
    require(not torch.equal(frames[0], frames[1]), "two seeds gave the same frame")

    # -- the frame against its all-plain counterpart -----------------------
    ref, ref_ok = plain_frame(params, static, model, basis, 2)
    # The kernels' scatter flags of that frame (the renderer keeps none).
    k_cs, _, _ = neural.CompactCamera().run(
        params, static, *cam.generate_rays(basis, WIDTH, HEIGHT, dev), 2,
        torch.arange(WIDTH * HEIGHT, device=dev))
    same = k_cs.has_scattered == ref_ok
    flat, rflat = frames[0].reshape(-1, 3), ref.reshape(-1, 3)
    rel = ((flat - rflat).abs() / rflat.abs().clamp(min=1e-3)).amax(dim=-1)
    flags_ok = same.float().mean().item()
    pix_ok = (rel[same] <= 1e-3).float().mean().item()
    print(f"frame vs plain: flags_agree={flags_ok:.6f} (tol 0.995) pixels_within_rtol1e-3="
          f"{pix_ok:.6f} (tol 0.999) max_rel={rel[same].max().item():.3g} "
          f"mean={flat.mean().item():.6f}", flush=True)
    require(flags_ok >= 0.995 and pix_ok >= 0.999, "the frame disagrees with its plain counterpart")

    phase_profile("profile", lambda: renderer.render_frame(params, static, WIDTH, HEIGHT, basis, seed=3),
                  frame_ms)
    del params, model, renderer, frames, warm, again, ref
    kernels = [dict(rows[k], launches=launches[k]) for k in ("K1", "K2", "K3")]

    # -- the path tracer's main path, counted --------------------------------
    for f in (pt.scatter_loop, ins_ops.sun_transmittance):
        f.launches = 0
    pt_runs = {res: phase_pt(port, config, procedural, pt, prog, res, dev) for res in (256, 64)}
    pt_launches = {"K4": pt.scatter_loop.launches, "K3": ins_ops.sun_transmittance.launches}
    print(f"PT launches: {json.dumps(pt_launches)} (K3 once per scene, K4 once per tick)", flush=True)
    require(all(n > 0 for n in pt_launches.values()),
            f"a kernel of the path tracer never launched: {pt_launches}")
    kernels.append(dict(rows["K4"], launches=pt_launches["K4"]))
    steps_per_s = {res: pt_work(pt, cam, res, run) for res, run in pt_runs.items()}
    del pt_runs

    # -- the probe's path, counted -------------------------------------------
    probe_rows = phase_probe(gather, steps_per_s[256])
    kernels += [probe_rows["P1"], probe_rows["P2"]]
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    try:
        kernels = run()
    except Failed as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
