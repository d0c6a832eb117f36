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
   bound is computed from.
3. ``frame``: the RPNN neural frame driven the way a user would drive it
   (build the scene, bake the in-scatter field, init ``DisneyModel`` from
   ``torch.Generator(566)``, render) at the reference's ``renderCloud``
   point: the 256^3 procedural cumulus of seed 11, 2000 m, uint8 textures,
   512 x 256.  Kernel launch counts are set to 0 just before and read just
   after; every kernel must have launched.  Frames must be finite,
   deterministic per seed and different across seeds.
4. ``frame vs plain``: the frame against one computed with every kernel's
   plain version, on every pixel whose scatter flag agrees.
5. ``profile``: the frame's device time by kernel (torch.profiler).

Then the card's ``name, power.limit`` line, the ``{"kernels": [...]}``
line, and as the last line ``{"ok": true, "device": {...}}``.  A failed
check exits 1 before the last line; without a CUDA device the run exits 1
and prints no result.
"""

from __future__ import annotations

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
K3_OPS_PER_STEP = 70
K2_OPS_PER_SAMPLE = 103
K2_OPS_PER_HI_LEVEL = 56

SEED_WEIGHTS = 566
WIDTH, HEIGHT = 512, 256


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


def kernel_row(name, source, replaces, err, ms, plain_ms, n_bytes, n_ops) -> dict:
    """One entry of the kernels line; the bound is the larger of the bytes
    over the HBM rate and the operations over the float32 peak."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations", library_ms=None)


def phase_build(cuda_build) -> None:
    t0 = time.time()
    secs = cuda_build.build()
    ptxas = {}
    for name in cuda_build.SOURCES:
        log = cuda_build.BUILD_DIR / f"{name}.log"
        lines = log.read_text().splitlines() if log.is_file() else []
        ptxas[name] = [ln.split("ptxas info    : ")[-1] for ln in lines if "Used" in ln]
    print(f"build: {time.time() - t0:.1f}s per-source={json.dumps({k: round(v, 1) for k, v in secs.items()})} "
          f"ptxas={json.dumps(ptxas)}", flush=True)


def phase_k3(ins_ops, params, static) -> dict:
    """K3 against its plain version over the whole grid.  Tolerance: T
    within 1e-5 (T in [0, 1]); quantized values equal on >= 99.9 %."""
    k3 = ins_ops.sun_transmittance(params, static)
    p3, steps = ins_ops.sun_transmittance_plain(params, static, return_steps=True)
    err = (k3 - p3).abs().max().item()
    q = lambda t: torch.floor(t * 255.0) / 255.0  # noqa: E731
    qmis = (q(k3) != q(p3)).float().mean().item()
    ms = time_ms(lambda: ins_ops.sun_transmittance(params, static), 3)
    plain = host_ms(lambda: ins_ops.sun_transmittance_plain(params, static))
    v, n_steps = k3.numel(), int(steps.sum().item())
    print(f"K3 bake: voxels={v} steps={n_steps} max_abs_err={err:.3g} (tol 1e-5) "
          f"quantized_mismatch={qmis:.3g} (tol 1e-3) ms={ms:.3f} plain_ms={plain:.1f}", flush=True)
    require(err <= 1e-5 and qmis <= 1e-3, "K3 disagrees with its plain version")
    return kernel_row("K3 inscatter bake", "deepestscatter_tpu_torch/csrc/inscatter.cu",
                      "deepestscatter_tpu/render/inscatter.py:38", err, ms, plain,
                      v * params.density_mips[0].element_size() + 4 * v,
                      n_steps * K3_OPS_PER_STEP)


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


def phase_profile(renderer, params, static, basis, frame_ms: float) -> None:
    """Device time of one frame by kernel.  Diagnostic only: a profiler
    that cannot trace the card prints ``unavailable`` and the run goes on."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            renderer.render_frame(params, static, WIDTH, HEIGHT, basis, seed=3)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # Device-side events only: a CPU op's self device time repeats its
        # kernels' time.
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    except (RuntimeError, AttributeError) as exc:
        print(f"profile: unavailable ({exc})", flush=True)
        return
    evs.sort(key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    top = [[e.key[:70], round(e.self_device_time_total / 1e3, 3), e.count] for e in evs[:12]]
    print(f"profile: kernels_ms={dev_ms:.3f} profiled_wall_ms={wall:.3f} "
          f"idle_share_vs_unprofiled_frame={1 - dev_ms / frame_ms:.3f} top={json.dumps(top)}",
          flush=True)


def run() -> dict:
    """All phases; returns the kernel rows with their launch counts."""
    import deepestscatter_tpu_torch as port
    from deepestscatter_tpu_torch import config, cuda_build
    from deepestscatter_tpu_torch.data import procedural
    from deepestscatter_tpu_torch.models.rpnn import init_disney_model
    from deepestscatter_tpu_torch.ops import descriptor as desc_ops
    from deepestscatter_tpu_torch.ops import grid as grid_ops
    from deepestscatter_tpu_torch.ops import march as march_ops
    from deepestscatter_tpu_torch.render import camera as cam
    from deepestscatter_tpu_torch.render import inscatter as ins_ops
    from deepestscatter_tpu_torch.render import neural

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
    del baked, scat, scat_dirs

    # -- the main path, counted --------------------------------------------
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

    phase_profile(renderer, params, static, basis, frame_ms)
    return [dict(rows[k], launches=launches[k]) for k in ("K1", "K2", "K3")]


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
