#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``deepestscatter_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, one output line each:

1. ``env`` / ``build``: the card, torch and CUDA versions; the kernels
   built from ``deepestscatter_tpu_torch/csrc`` (one nvcc per source, in
   parallel, P1's designs included) with their ptxas register reports.
2. ``K3`` / ``K1`` / ``K2``: each kernel against its plain PyTorch version
   at the operating point's shapes, with the tolerance it must meet, its
   time (CUDA events), the plain version's time and the work counts its
   bound is computed from.  K3, K2 and K1's transmittance must equal their
   plain versions bitwise; ``K1 lanes`` gives K1's lanes a ray and lane
   utilisation (steps over lane-step slots, from the kernel's counters).
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
   (the neural frame, the BNN frame, the path tracer, the probe, the
   collector, training) and read just after; every kernel must have
   launched on its path.  Frames must be
   finite, deterministic per seed and different across seeds.
5. ``frame vs plain``: the frame against one computed with every kernel's
   plain version, on every pixel whose scatter flag agrees.
6. ``profile``: the frame's device time by kernel (torch.profiler).
7. ``BNN bake`` / ``BNN frame``: the baked light-probe renderer on the same
   scene, driven the way a user drives it (``LightProbeModel`` and
   ``ProbeRendererModel`` from ``torch.Generator(566)``, ``BakedRenderer``
   bakes its 35^3 probe lattice through K2 at 9 layers, then frames through
   K1, K5 and K2 at 3 layers): the bake's seconds and launches, the probes
   equal to a bake through K2's plain version, the mean of 6 frames beside
   the RPNN's of this run, the same frame gates; ``BNN frame vs plain`` and
   ``BNN profile`` as for the RPNN; ``K2 3 layers`` / ``K2 9 layers`` and
   ``K5``: the kernels against their plain versions (bitwise) at the BNN's
   shapes, K5 with its ``index_select`` + ``bmm`` yardstick.
8. ``PT``: ``ProgressiveRenderer`` driven the way a user would drive it
   (build, bake, ticks of 2 subframes at 512^2, ``run()`` with a small
   ``ProgressiveConfig``, ``display_image``) at 256^3 and 64^3: Mrays/s,
   steps/s, image mean, launches, peak memory, and the device time of 10
   ticks by kernel (torch.profiler).  The image mean must lie
   in (0.1, 10), be finite, repeat for the same seed and differ across
   seeds.
9. ``P1`` / ``P2``: the row-gather probe's entry point
   (``probes.gather.main``) at the Pallas probe's cases, each kernel's sums
   equal to its plain version's; then P1 at a table the size of the 256^3
   texture beside K4's step rate (the path tracer's gather ceiling), and
   ``P1 designs``: P1's three designs (``probes.gather.variants``) timed in
   turns.
10. ``card vs cpu``: K2 at 10 layers and K5 on 4,096 of the BNN frame's
    shading points and K7a on 1,024 samples of the same scene, each kernel
    on the card against its plain version on the CPU (the scene copied with
    ``scene.params_to``), at the CPU parity tests' tolerances (K2 atol
    1e-5; K5 latents 1e-6, angles 1e-5 modulo 2 pi; K7a found flags and
    attempt counts equal on >= 99.5 %, positions within 1e-4 where the
    attempts agree), with each max abs err and its bitwise share.
11. ``collect``: the dataset generator driven the way a user drives it:
    the train store of a ``DatasetTriplet`` in a temporary directory
    holding one SceneSetup (the 256^3 procedural cumulus of seed 11, 2000
    m, the ``Front`` light), and
    ``tasks.collect`` over its four stages at the reference's operating
    point (2,048 samples, the default ``PointRadianceConfig``, the
    production scene settings), counted (K7a, K7b, K2, K3 must launch).
    Each stage's seconds, peak memory; then, through the collectors on the
    stored samples, samples found and attempts, and the radiance schedule,
    converged and black counts and experiments (``estimate_point_radiance``
    again, its labels and flags equal to the stored ones).  Gates: K3 on
    the collector's scene (the padded 258^3 grid, the ``Front`` light)
    bitwise equal to its plain version; K7a against its plain version on
    the card (found flags, positions, directions, attempts and steps
    bitwise equal on every sample; equal to the stored samples); K7b at the radiance stage's first update (20,480
    lanes x 100 experiments, bases 0) and at that shape with bases
    2^32 - 50: each lane's fold equal to its per-experiment records folded
    in order (counts, steps and scatters equal; moments within K4's
    tolerances), and 1,024 records of each launch, drawn at random, equal
    to one-experiment plain runs of their lanes with the base sub0 + k
    (steps and scatters equal, radiance within 1e-5 of the max; the row's
    plain_ms is those 2,048 experiments', the plain loop at the update's
    shape being too long to run); the stored descriptor grids and baked
    sets equal to those through K2's plain version; samples in the box with
    unit directions; labels finite, >= 0, mean > 0; baked powers summing
    to 1 within 1e-4; every table 2,048 records.

12. ``train``: training on what ``collect`` wrote, the way a user trains:
    the collect phase's store is the train store of a ``DatasetTriplet``
    whose validation store stays empty (the fallback's WARNING must
    appear); ``entries.train_disney`` and ``entries.train_baked`` with
    device-resident batches (K10) at full width on the reference recipe
    (batch 1,024, validation every 40 steps, lr 1e-3), 40 epochs of one
    step each, counted (K10 must launch in both layouts): steps, seconds,
    the validation loss at the initial weights and at the end (it must
    fall), peak memory.  ``K10 batch assembly (RPNN)`` / ``(baked)``: K10
    against its plain version at a batch of 1,024 of the collected tables,
    bitwise; its device time (profiler) with the L2 flushed before each
    call (its row's ``ms``: the bound counts HBM bytes) and back to back
    (L2-warm), its back-to-back event time, the plain version's, and the
    PyTorch chain's device time (``index_select``, ``float``, ``div``,
    ``cat``; its row's ``library_ms``, L2 flushed).  ``train ... profile``: ms a step (median of 5
    synchronized chunks of 10 steps), a chunk's device time by kernel, the
    GEMMs' and the idle share.  ``train card vs cpu``: the same
    ``flax_init`` weights, 5 steps on the same schedule on the card and on
    the CPU (K10's plain version there), each loss within a relative 1e-4;
    the optimizer's updates from identical gradients within 1e-6.
    ``train resume``: a run stopped after one chunk and restored into a
    fresh ``Trainer`` reaches the uninterrupted run's parameters and
    moments bitwise.  ``train NN frame`` / ``train BNN frame``: the
    exports (``DisneyModel.pt``; ``LightProbeModel.pt`` and
    ``ProbeRendererModel.pt``) loaded into ``DisneyRenderer`` and
    ``BakedRenderer`` render the collected scene at 512 x 256 under
    ``check_frames``, unlike the random weights' frame of the same seed.

13. ``JAX ground truth``: the port against the JAX package's committed
    render of the end-to-end evaluation's held-out scene
    (``runs/eval_e2e/renders_512x256/eval.PT.exr``, 2,380 subframes of
    seed 3: its job stopped at a wall-clock budget; the scene in
    ``EVAL_r05.json``: ``procedural:64:29``, 2677.73 m, its light, 512 x
    256, Russian roulette from bounce 64, uint8), driven the way a user
    drives it: ``tasks.eval_scene``, ``tasks.scene_from_setup``,
    ``ProgressiveRenderer``; counted (K3 and K4 must launch).  First the
    port's first 20 subframes of seed 3 against the JAX package's on the
    CPU (``runs/port_eval/eval.PT.jax_cpu_20sf.exr``, the same seed and so
    mostly the same paths): >= 98 % of pixel channels within 1e-3
    (relative), the image means within 1e-4 (relative).  Then seed 3 to
    2,370, 2,380 and 2,390 subframes: its mean absolute difference to the
    file least at 2,380, and there the difference of the image means
    within 4 of its standard errors, taken from the spread of the
    per-pixel differences (``utils.compare.paired_difference``; the two
    share their paths but where the TPU's float functions parted them).
    Then ``run()`` to the CI gate (at most 7,000 subframes) for seeds 4
    and 5, pooled (``utils.compare.pool_renders``) and gated
    (``utils.compare.render_agreement``, the file's noise that of a
    2,380-subframe render): the image means within 4 standard errors of
    their difference, from the port's per-pixel Welford moments with a
    pixel's three channels taken as perfectly correlated (the path
    tracer's are: their m2 are equal); the tone-mapped RMS (``rms_bias``)
    at most 1.5 times the RMS the two images' noise alone gives.  Both
    gates must refuse the port's image scaled by 1.02.  It prints each
    seed's line, the pool's subframes, image mean against EVAL_r05's
    2.27659, the difference (absolute and relative), the z-scores, both
    RMS and the share of pixel channels past 4 sigma.

14. ``eval``: the end-to-end quality check (D5) at EVAL_r05's operating
    point, the way a user runs it (``eval_e2e.run_r05``): the round-5 stores
    (``seed_r05``) in a temporary directory; the four collector stages on
    train scene 0 (``procedural:64:21``, 1,200 m; 2,048 samples; roulette
    from bounce 64, uint8, 20,000 black experiments), the validation store
    left with its 4 setups and no labels (the fallback's WARNING must
    appear); ``train_disney`` for 200 epochs and ``train_baked`` for 100 on
    the default recipe, device-resident; the NN and BNN frames of the
    held-out scene (``procedural:64:29``, 2677.73 m, EVAL_r05's light) at
    512 x 256, seed 3, with the trained exports and with untrained weights
    (``":init:"``), each against the committed
    ``runs/eval_e2e/renders_512x256/eval.PT.exr`` (read, never rendered).
    Counted: K3, K7a, K7b, K2, K10, K1 and K5 must launch.  It prints the
    four RMS values beside EVAL_r05's with their ratios, the validation
    losses, steps, each stage's seconds, the converged labels and peak
    memory, and the trained frames' means and RMS against the JAX
    package's own frames committed beside the ground truth.  Gates: every
    frame finite; trained RMS <= 0.6 x the untrained weights' RMS of the
    same run (EVAL_r05: 0.38 and 0.44); trained RMS <= 1.5 x EVAL_r05's
    (NN <= 0.0854, BNN <= 0.0894).
15. ``CLI``: ``python -m deepestscatter_tpu_torch render procedural:64:29
    --size-m 2677.73 --directions Side`` in a subprocess from the
    repository root, ``--renderer bnn --models-dir`` the eval phase's
    exports, then ``--renderer pt --max-subframes 4``.  Gates: each EXR
    exists, is finite and 256 x 512 x 3; the BNN EXR equals, bitwise, the
    same render through ``tasks.render_cloud`` in this process.

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
from pathlib import Path

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
#: K5: per point the lattice cell and local position, up to four half-space
#: tests, five scalar triple products and a reciprocal for the weights, the
#: corners' clamps and indices, omega and alpha (two light frames, two
#: acos); per latent channel four dequantized corners weighted and summed.
K5_OPS_PER_POINT = 330
K5_OPS_PER_CHANNEL = 15
#: K7a: per march step K1's count; per attempt four hashes and the sphere
#: and disc samples (two sincos), the normal's frame, the slab test and
#: the entry, the AABB jump and the acceptance test.
K7A_OPS_PER_STEP = K1_OPS_PER_STEP
K7A_OPS_PER_ATTEMPT = 150

SEED_WEIGHTS = 566
WIDTH, HEIGHT = 512, 256
#: The path tracer's operating point (bench.py): 512^2, 2 subframes a tick.
PT_SIZE = 512
PT_SUBFRAMES = 2
PT_SEED = 5
PT_SECONDS = 3.0
K4_SUBSET_STRIDE = 16  # 16,384 of the 262,144 pixels
#: Times before each kernel's redesign, quoted from PERF.md (this script on
#: an H100 80GB HBM3 at 700 W) on the human-readable lines only.
PREV_MS = {"K3": 61.05, "K4": 6.105, "K1": 1.481, "K2": 2.861, "P1": 0.1479, "K5": 0.0373,
           "K7a": 0.1168, "K7b": 28.71}
#: The collector's operating point: one scene, the reference's batch.
COLLECT_CLOUD = "procedural:256:11"
COLLECT_SIZE_M = 2000.0
COLLECT_STAGES = ("ScatterSample", "Result", "DisneyDescriptor", "BakedInterpolationSet")
#: K7b's records checked against one-experiment plain runs, per launch.
K7B_CHECKED = 1024
#: The end-to-end evaluation's record and its committed JAX ground truth.
EVAL_JSON = Path(__file__).resolve().parent / "EVAL_r05.json"
EVAL_REFERENCE = Path(__file__).resolve().parent / "runs/eval_e2e/renders_512x256/eval.PT.exr"
#: Its seed and its subframes: tools/render_pt_r05.py stops at a
#: wall-clock budget, and the file holds 2,380 subframes, where the port's
#: render of seed 3 comes closest to it (probes/ground_truth.py).
EVAL_REFERENCE_SEED = 3
EVAL_REFERENCE_SUBFRAMES = 2380
#: The seeds whose renders, pooled, are held against it: not the
#: reference's own, whose paths a render of that seed would share.
EVAL_SEEDS = (4, 5)
#: The scale of the port's image that the ground-truth gate must refuse.
EVAL_SCALE = 1.02
#: The JAX package's first 20 subframes of that render at the reference's
#: seed on the CPU (tests/jax_reference_check.py --subframes 20 --exr ...).
EVAL_JAX_CPU = Path(__file__).resolve().parent / "runs/port_eval/eval.PT.jax_cpu_20sf.exr"
EVAL_JAX_CPU_SUBFRAMES = 20
#: Card-against-CPU sizes (the CPU runs the plain versions).
CPU_POINTS = 4096
CPU_SAMPLES = 1024


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


#: Bytes written between timed calls to evict the 50 MB L2 (``cold``).
L2_FLUSH_BYTES = 64 * 2**20


def device_ms(fn, reps: int, kernel: str = "", cold: bool = False) -> float:
    """Mean device time a call of ``fn`` spends in kernels whose name holds
    ``kernel`` (every kernel for ""), from torch.profiler over ``reps``
    calls after a warm-up: for launches shorter than their host-side cost,
    which CUDA events would time instead.  ``cold``: each call after
    writing L2_FLUSH_BYTES (whose kernel is left out), so that its inputs
    come from HBM; back to back, a call whose bytes fit the L2 finds them
    there.  The profiler can miss launches (it saw 7 of 10 K7a launches in
    one run), so each kernel's time is the mean of the launches it saw,
    times its launches a call; a line says where launches went unseen."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof):
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]

    flush = torch.empty(L2_FLUSH_BYTES if cold else 0, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    skip = set()
    if cold:
        with profile(activities=[ProfilerActivity.CUDA]) as fprof:
            flush.zero_()
            torch.cuda.synchronize()
        skip = {e.key for e in kernels(fprof)}
    evs = [e for e in kernels(prof) if kernel in e.key and e.key not in skip]
    require(bool(evs), f"the profiler saw no device time of {kernel or 'any kernel'}")
    total = 0.0
    for e in evs:
        per_call = max(1, round(e.count / reps))
        if e.count != per_call * reps:
            print(f"device_ms: the profiler saw {e.count} launches of {e.key[:50]!r} in {reps} "
                  f"calls; the mean of those seen is used", flush=True)
        total += e.self_device_time_total / e.count * per_call
    return total / 1e3


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


#: Sources built beside the package's: P1's designs (probes.gather.variants).
EXTRA_SOURCES = ("gather_variants",)


def phase_build(cuda_build) -> None:
    t0 = time.time()
    names = cuda_build.SOURCES + EXTRA_SOURCES
    secs = cuda_build.build(names)
    ptxas = {}
    keep = ("entry function", "spill", "Used")
    for name in names:
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


def phase_k1(march_ops, cuda_build, params, static, entry, dirs, ids):
    """K1 against its plain version on the frame's box hits (pass 1) and
    its T < 1 rays (pass 2).  Tolerance: T bitwise equal (max abs err 0);
    ok flags equal on >= 99.5 % of rays; on rays both flag, positions
    within 1e-4 and direct light within 1e-3 of the largest, on >= 99.5 %.
    Also prints the share of pass-2 rays whose ok, position and direct
    light are bitwise equal, each pass's time, and the lane utilisation
    from the kernel's counters, whose steps must equal the plain version's.
    Returns the kernel row and the pass-2 result (the frame's shading
    points)."""
    k1 = march_ops.camera_march(params, static, entry, dirs)
    util = [tuple(int(v) for v in march_ops.camera_march.last_counters.tolist())]
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
    util.append(tuple(int(v) for v in march_ops.camera_march.last_counters.tolist()))
    p2 = march_ops.camera_march_plain(params, static, e2, d2, 1, ids2, t2)
    err = max(err, (k2.transmittance - p2.transmittance).abs().max().item())
    agree = (k2.ok == p2.ok).float().mean().item()
    both = k2.ok & p2.ok
    pos_ok = ((k2.scatter_pos - p2.scatter_pos)[both].abs().amax(dim=-1) <= 1e-4).float().mean().item()
    dmax = p2.direct.abs().max().item()
    direct_ok = ((k2.direct - p2.direct)[both].abs().amax(dim=-1) <= 1e-3 * dmax).float().mean().item()
    bitwise = ((k2.ok == p2.ok) & (k2.scatter_pos == p2.scatter_pos).all(dim=-1)
               & (k2.direct == p2.direct).all(dim=-1)).float().mean().item()
    ms1 = time_ms(lambda: march_ops.camera_march(params, static, entry, dirs), 5)
    ms2 = time_ms(lambda: march_ops.camera_march(params, static, e2, d2, 1, ids2, t2), 5)
    ms = time_ms(lambda: (march_ops.camera_march(params, static, entry, dirs),
                          march_ops.camera_march(params, static, e2, d2, 1, ids2, t2)), 5)
    plain = host_ms(lambda: (march_ops.camera_march_plain(params, static, entry, dirs),
                             march_ops.camera_march_plain(params, static, e2, d2, 1, ids2, t2)))
    n1, n2 = entry.shape[0], e2.shape[0]
    s1, s2 = int(ev1.steps.sum().item()), int(ev1.steps[sel].sum().item())
    g = cuda_build.load("march").ds_march_lanes()
    lanes = [steps / slots for slots, steps in util]
    print(f"K1 march: pass1_rays={n1} pass2_rays={n2} steps={s1}+{s2} T_max_abs_err={err:.3g} (tol 0) "
          f"ok_agree={agree:.6f} pos_within_1e-4={pos_ok:.6f} direct_within_1e-3max={direct_ok:.6f} "
          f"(tol 0.995) pass2_bitwise(ok,pos,direct)={bitwise:.6f} ms(pass1+pass2)={ms:.3f} "
          f"pass1_ms={ms1:.3f} pass2_ms={ms2:.3f} before_redesign_ms(PERF.md)={PREV_MS['K1']} "
          f"plain_ms={plain:.1f}", flush=True)
    print(f"K1 lanes: G={g} lane_step_slots={util[0][0]}+{util[1][0]} kernel_steps={util[0][1]}+{util[1][1]} "
          f"lane_utilisation(steps / slots)=pass1 {lanes[0]:.4f} pass2 {lanes[1]:.4f} "
          f"both {(util[0][1] + util[1][1]) / (util[0][0] + util[1][0]):.4f}", flush=True)
    require(err == 0.0 and min(agree, pos_ok, direct_ok) >= 0.995,
            "K1 disagrees with its plain version")
    require((util[0][1], util[1][1]) == (s1, s2), "K1's step counter disagrees with the plain steps")
    tex = params.density_mips[0].numel() * params.density_mips[0].element_size()
    n_bytes = 2 * tex + params.phase.eval_rows.numel() * 4 + n1 * 28 + n2 * 65
    row = kernel_row("K1 camera march + NEE", "deepestscatter_tpu_torch/csrc/march.cu",
                     "deepestscatter_tpu/ops/march.py:100", err, ms, plain, n_bytes,
                     (s1 + s2) * K1_OPS_PER_STEP + (n1 + n2) * K1_OPS_PER_RAY)
    return row, k2, d2


def k2_work(desc_ops, grid_ops, params, static, m: int, layers: int):
    """K2's work on ``m`` points at ``layers`` layers → (bytes: the pyramid,
    the points and the output once; operations: 103 a stencil sample and 56
    a second mip level)."""
    n_hi = sum(1 for _, _, lod in desc_ops.layer_plan(static, layers)
               if grid_ops.mip_lerp_levels(static.n_mips, lod)[4])
    n_ops = m * 225 * (layers * K2_OPS_PER_SAMPLE + n_hi * K2_OPS_PER_HI_LEVEL)
    n_bytes = (params.mip_flat.numel() * params.mip_flat.element_size() + m * 24
               + m * layers * 226 * 4)
    return n_bytes, n_ops


def phase_k2(desc_ops, grid_ops, params, static, pts, dirs) -> dict:
    """K2 against its plain version on the frame's shading points, in one
    launch: bitwise (max abs err 0)."""
    kd = desc_ops.network_inputs(params, static, pts, dirs)
    pd = desc_ops.network_inputs_plain(params, static, pts, dirs)
    err = (kd - pd).abs().max().item()
    ms = time_ms(lambda: desc_ops.network_inputs(params, static, pts, dirs), 5)
    plain = host_ms(lambda: desc_ops.network_inputs_plain(params, static, pts, dirs))
    m = pts.shape[0]
    print(f"K2 descriptor: points={m} out={tuple(kd.shape)} max_abs_err={err:.3g} (tol 0) "
          f"ms={ms:.3f} elements_per_s={kd.numel() / (ms * 1e-3):.4g} "
          f"before_redesign_ms(PERF.md)={PREV_MS['K2']} plain_ms={plain:.1f}", flush=True)
    require(err == 0.0, "K2 disagrees with its plain version")
    n_bytes, n_ops = k2_work(desc_ops, grid_ops, params, static, m, desc_ops.DISNEY_LAYERS)
    return kernel_row("K2 descriptor stencil", "deepestscatter_tpu_torch/csrc/descriptor.cu",
                      "deepestscatter_tpu/ops/descriptor.py:92", err, ms, plain, n_bytes, n_ops)


def phase_k2_baked(desc_ops, grid_ops, baked, params, static, pts, dirs, lattice) -> None:
    """K2 at the BNN's layer counts against its plain version, bitwise: 3
    layers on the BNN frame's shading points (one launch), 9 layers in the
    probe direction's frame on every probe of the lattice (one launch; the
    bake runs it in chunks)."""
    probes_pos = baked.probe_positions(static, lattice, pts.device)
    frames = baked.probe_frames(probes_pos.shape[0], pts.device)
    for label, pos, d, layers, frame in (
        ("3 layers (BNN realtime)", pts, dirs, desc_ops.BAKED_REALTIME_LAYERS, None),
        ("9 layers (probe bake)", probes_pos, frames, desc_ops.LIGHTPROBE_LAYERS, frames),
    ):
        kd = desc_ops.network_inputs(params, static, pos, d, layers, frame)
        pd = desc_ops.network_inputs_plain(params, static, pos, d, layers, frame)
        err = (kd - pd).abs().max().item()
        ms = time_ms(lambda: desc_ops.network_inputs(params, static, pos, d, layers, frame), 5)
        n_bytes, n_ops = k2_work(desc_ops, grid_ops, params, static, pos.shape[0], layers)
        row = kernel_row("", "", "", err, ms, 0.0, n_bytes, n_ops)
        print(f"K2 {label}: points={pos.shape[0]} out={tuple(kd.shape)} max_abs_err={err:.3g} "
              f"(tol 0) ms={ms:.4f} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"elements_per_s={kd.numel() / (ms * 1e-3):.4g}", flush=True)
        require(err == 0.0, f"K2 at {layers} layers disagrees with its plain version")


def phase_k5(baked, params, static, probes, pts, dirs) -> dict:
    """K5 against its plain version on the BNN frame's shading points:
    bitwise.  Its yardstick (``library_ms``): ``index_select`` of the 4 N
    corner rows of a float32 copy of the lattice and one ``torch.bmm`` with
    the [N, 1, 4] weights (the corners and weights from the plain version,
    outside the timing).  Both are timed on the device by the profiler: a
    K5 launch takes less device time than its wrapper takes on the host."""
    k = baked.interpolate_probes(params, static, probes, pts, dirs)
    p = baked.interpolate_probes_plain(params, static, probes, pts, dirs)
    err = (k - p).abs().max().item()
    require(torch.equal(k, p), f"K5 disagrees with its plain version (max abs err {err:.3g})")
    launch = lambda: baked.interpolate_probes(params, static, probes, pts, dirs)  # noqa: E731
    first = lambda: baked._launch(params, static, probes, pts, dirs, entry="ds_probes_first")  # noqa: E731
    require(torch.equal(first(), k), "K5's first design disagrees with its redesign")
    turns = [device_ms(f, 20, name) for f, name in ((launch, "probes_kernel"),
                                                     (first, "probes_first_kernel"),
                                                     (first, "probes_first_kernel"),
                                                     (launch, "probes_kernel"))]
    ms, first_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    wrapper_ms = time_ms(launch, 20)
    plain = host_ms(lambda: baked.interpolate_probes_plain(params, static, probes, pts, dirs))
    n = pts.shape[0]
    idx, w = baked.probe_corners(probes.shape, static, pts)
    rows = probes.reshape(-1, baked.PROBE_LENGTH).to(torch.float32)
    if probes.dtype == torch.uint8:
        rows = rows / 256.0
    flat_idx = idx.reshape(-1)

    def library():
        return torch.bmm(w[:, None, :], rows.index_select(0, flat_idx).view(n, 4, -1))

    lib_err = (library()[:, 0] - k[:, : baked.PROBE_LENGTH]).abs().max().item()
    library_ms = device_ms(library, 20)
    distinct = int(torch.unique(flat_idx).numel())
    out_bytes = n * baked.PROBE_IN_WIDTH * 4
    n_bytes = distinct * baked.PROBE_LENGTH * probes.element_size() + n * 24 + out_bytes
    corner_bytes = n * 4 * baked.PROBE_LENGTH * probes.element_size() + n * 24 + out_bytes
    n_ops = n * (K5_OPS_PER_POINT + baked.PROBE_LENGTH * K5_OPS_PER_CHANNEL)
    row = kernel_row("K5 probe interpolation", "deepestscatter_tpu_torch/csrc/probes.cu",
                     "deepestscatter_tpu/render/baked.py:125", err, ms, plain, n_bytes, n_ops,
                     library_ms)
    print(f"K5 probe interpolation: points={n} lattice={tuple(probes.shape)} {probes.dtype} "
          f"distinct_probes={distinct} max_abs_err={err:.3g} (tol 0, torch.equal) "
          f"ms(device, profiler)={ms:.4f} turns(redesign, first, first, redesign)="
          f"{[round(t, 4) for t in turns]} first_design_ms={first_ms:.4f} "
          f"before_redesign_ms(PERF.md)={PREV_MS['K5']} wrapper_ms(CUDA events, launches back to back)="
          f"{wrapper_ms:.4f} plain_ms={plain:.3f} library_ms(index_select+bmm, device)={library_ms:.4f} "
          f"(latents within {lib_err:.3g} of K5's) bound_ms={row['bound_ms']:.4f} ({row['bound_by']}: "
          f"distinct probes once, {n_bytes / 1e6:.1f} MB) bound_ms(4 corners a point read)="
          f"{corner_bytes / HBM_BYTES_PER_S * 1e3:.4f}", flush=True)
    return row


def plain_descriptors(desc_ops, fn, *args):
    """``fn(*args)`` with K2's plain version in the kernel's place (the
    probe bake with its own chunking, the collectors' descriptors)."""
    kernel = desc_ops.network_inputs
    desc_ops.network_inputs = desc_ops.network_inputs_plain
    try:
        return fn(*args)
    finally:
        desc_ops.network_inputs = kernel


def phase_bnn(port, baked, desc_ops, grid_ops, march_ops, params, static, basis, dev,
              rpnn_ms: float) -> dict:
    """The baked-probe (BNN) frame driven the way a user drives it, on the
    neural frame's scene: both models from ``torch.Generator(566)``, the
    probe bake at construction, a warm-up frame, 6 timed frames.  Launch
    counts are set to 0 just before the renderer is built and read after
    the timed frames; K1, K2 and K5 must each have launched.  Returns K5's
    kernel row with its launches."""
    from deepestscatter_tpu_torch.models.probes import (init_light_probe_model,
                                                        init_probe_renderer_model)

    counters = {"K1": march_ops.camera_march, "K2": desc_ops.network_inputs,
                "K5": baked.interpolate_probes}
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    probe_model = init_light_probe_model(SEED_WEIGHTS, device=dev)
    renderer_model = init_probe_renderer_model(SEED_WEIGHTS, device=dev)
    renderer = port.BakedRenderer(params, static, probe_model, renderer_model, device=dev)
    torch.cuda.synchronize()
    bake_s = time.time() - t0
    bake_k2 = desc_ops.network_inputs.launches
    render = lambda seed: renderer.render_frame(params, static, WIDTH, HEIGHT, basis, seed=seed)  # noqa: E731
    warm = render(1)
    frames, times, peak = timed_frames(render)
    launches = {k: f.launches for k, f in counters.items()}
    n_rays, n_hit, n_scat = renderer.last_counts
    bnn_ms = float(np.mean(times))
    probes = renderer.probes
    same_bake = torch.equal(probes, plain_descriptors(desc_ops, baked.bake_probes, params,
                                                      static, probe_model, renderer.lattice))
    print(f"BNN bake: lattice={renderer.lattice} (expect (35, 35, 35)) probes={tuple(probes.shape)} "
          f"{probes.dtype} setup(init+bake)={bake_s:.3f}s K2_launches(9 layers, chunks of "
          f"{baked.BAKE_CHUNK})={bake_k2} probe_mean={probes.float().mean().item():.4f} "
          f"equal_to_plain_K2_bake={same_bake}", flush=True)
    require(same_bake, "the probe bake disagrees with the bake through K2's plain version")
    tiles = -(-n_scat // renderer.TILE)
    print(f"BNN frame: frames={len(times)} ms_per_frame_mean={bnn_ms:.3f} ms_min={min(times):.3f} "
          f"ms_all={[round(t, 3) for t in times]} rpnn_ms_per_frame_mean(this run)={rpnn_ms:.3f} "
          f"frac_hit={n_hit / n_rays:.4f} frac_scattered={n_scat / n_rays:.4f} "
          f"peak_mem_mb={peak / 2**20:.1f} launches={json.dumps(launches)} (bake: K2 {bake_k2}; "
          f"per frame: K1 2, K2 {tiles}, K5 {tiles})", flush=True)
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the BNN path never launched: {launches}")
    check_frames("BNN frame", [warm] + frames, render(2), frames)

    def shade_plain(p, d):
        probe_in = baked.interpolate_probes_plain(params, static, probes, p, d)
        realtime = desc_ops.network_inputs_plain(params, static, p, d,
                                                 desc_ops.BAKED_REALTIME_LAYERS)
        return renderer_model(probe_in, realtime)[:, 0]

    k_cs, d = against_plain("BNN frame vs plain", params, static, frames[0], basis, shade_plain)
    phase_profile("BNN profile", lambda: render(3), bnn_ms)
    pts = k_cs.scatter_pos[k_cs.has_scattered].contiguous()
    pdirs = d[k_cs.has_scattered].contiguous()
    phase_k2_baked(desc_ops, grid_ops, baked, params, static, pts, pdirs, renderer.lattice)
    row = dict(phase_k5(baked, params, static, probes, pts, pdirs), launches=launches["K5"])
    return row, (pts, pdirs, probes)


def angle_err(a, b):
    """|a - b| modulo 2 pi, and that difference less two float32 ulps of
    the cosine times acos' slope (<= 0 where within them)."""
    d = (a - b).abs()
    d = torch.minimum(d, 2.0 * np.pi - d)
    slope = 1.0 / torch.sqrt(torch.clamp(1.0 - torch.cos(b) ** 2, min=1e-12))
    return d, d - 2.0 * 1.2e-7 * slope


def phase_card_vs_cpu(desc_ops, baked, collectors, scene_mod, params, static, pts, dirs,
                      probes) -> None:
    """K2 (10 layers), K5 and K7a on the card against their plain versions
    on the CPU, on the same inputs: the CPU parity tests' tolerances."""
    cpu = scene_mod.params_to(params, "cpu")
    n = min(CPU_POINTS, pts.shape[0])
    p, d = pts[:n].contiguous(), dirs[:n].contiguous()
    pc, dc = p.cpu(), d.cpu()
    kd = desc_ops.network_inputs(params, static, p, d).cpu()
    cd = desc_ops.network_inputs_plain(cpu, static, pc, dc)
    err2 = (kd - cd).abs().max().item()
    print(f"card vs cpu K2 (10 layers): points={n} max_abs_err={err2:.3g} (tol 1e-5) "
          f"bitwise_share={(kd == cd).float().mean().item():.6f}", flush=True)
    k5 = baked.interpolate_probes(params, static, probes, p, d).cpu()
    c5 = baked.interpolate_probes_plain(cpu, static, probes.cpu(), pc, dc)
    w = baked.PROBE_LENGTH
    err5 = (k5[:, :w] - c5[:, :w]).abs().max().item()
    ang, ang_excess = angle_err(k5[:, w:], c5[:, w:])
    print(f"card vs cpu K5: points={n} latents_max_abs_err={err5:.3g} (tol 1e-6) "
          f"angles_max_abs_err(mod 2 pi)={ang.max().item():.3g} (tol 1e-5 + acos slope) "
          f"bitwise_share={(k5 == c5).float().mean().item():.6f}", flush=True)
    ks = collectors.generate_scatter_samples(params, static, CPU_SAMPLES, 1)
    cs = collectors.generate_scatter_samples_plain(cpu, static, CPU_SAMPLES, 1)
    found = ks.found.cpu()
    agree = (found == cs.found).float().mean().item()
    att_agree = (ks.attempts.cpu() == cs.attempts).float().mean().item()
    same = (ks.attempts.cpu() == cs.attempts) & found & cs.found
    err7 = (ks.positions.cpu() - cs.positions)[same].abs().max().item()
    bit7 = (same & (ks.positions.cpu() == cs.positions).all(dim=-1)).float().mean().item()
    print(f"card vs cpu K7a: samples={CPU_SAMPLES} found_agree={agree:.6f} (tol 0.995) "
          f"attempts_agree={att_agree:.6f} (tol 0.995) pos_max_abs_err={err7:.3g} "
          f"(tol 1e-4) bitwise_share={bit7:.6f}", flush=True)
    require(err2 <= 1e-5, "card vs cpu: K2 beyond 1e-5")
    require(err5 <= 1e-6 and bool((ang_excess <= 1e-5).all()), "card vs cpu: K5 beyond tolerance")
    require(agree >= 0.995 and att_agree >= 0.995 and err7 <= 1e-4,
            "card vs cpu: K7a beyond tolerance")


def plain_frame(params, static, shade_plain, basis, seed):
    """The frame computed with every kernel's plain version on the card,
    ``shade_plain(pos, dirs)`` giving the scattered points' predicted
    radiance → (image, scatter flags)."""
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
        pred[idx3] = shade_plain(pos[idx3], d[idx3])
    cs = neural.ConditionalScatter(trans, pos, ok, direct)
    miss = cam.miss_radiance(params, static, d)
    return neural.composite(pred, cs, miss, hit).reshape(HEIGHT, WIDTH, 3), ok


def timed_frames(render, seeds=range(2, 8)):
    """``render(seed)`` for each seed, each timed by the host clock around
    a synchronized frame → (frames, ms, peak device bytes)."""
    torch.cuda.reset_peak_memory_stats()
    frames, times = [], []
    for seed in seeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames.append(render(seed))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return frames, times, torch.cuda.max_memory_allocated()


def check_frames(label: str, images, again, frames) -> None:
    """Every image finite and of the frame's shape; ``again`` (seed 2
    rendered anew) equal to ``frames[0]``; seeds 2 and 3 different."""
    require(all(img.shape == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(img).all())
                for img in images), f"{label}: a frame is not finite or has the wrong shape")
    require(torch.equal(again, frames[0]), f"{label}: the same seed gave a different frame")
    require(not torch.equal(frames[0], frames[1]), f"{label}: two seeds gave the same frame")


def against_plain(label: str, params, static, frame, basis, shade_plain, seed: int = 2):
    """The ``seed`` ``frame`` against the all-plain frame of the same seed:
    scatter flags agree on >= 0.995 of rays, and >= 0.999 of the agreeing
    pixels lie within rtol 1e-3 (relative to max(|plain|, 1e-3)).  Returns
    the kernels' camera result of that frame and its ray directions."""
    from deepestscatter_tpu_torch.render import camera as cam
    from deepestscatter_tpu_torch.render import neural

    dev = params.bbox_size.device
    ref, ref_ok = plain_frame(params, static, shade_plain, basis, seed)
    # The kernels' scatter flags of that frame (the renderers keep none).
    o, d = cam.generate_rays(basis, WIDTH, HEIGHT, dev)
    k_cs, _, _ = neural.CompactCamera().run(params, static, o, d, seed,
                                            torch.arange(WIDTH * HEIGHT, device=dev))
    same = k_cs.has_scattered == ref_ok
    flat, rflat = frame.reshape(-1, 3), ref.reshape(-1, 3)
    rel = ((flat - rflat).abs() / rflat.abs().clamp(min=1e-3)).amax(dim=-1)
    flags_ok = same.float().mean().item()
    pix_ok = (rel[same] <= 1e-3).float().mean().item()
    print(f"{label}: flags_agree={flags_ok:.6f} (tol 0.995) pixels_within_rtol1e-3="
          f"{pix_ok:.6f} (tol 0.999) max_rel={rel[same].max().item():.3g} "
          f"mean={flat.mean().item():.6f}", flush=True)
    require(flags_ok >= 0.995 and pix_ok >= 0.999, f"{label}: the frame disagrees with its plain counterpart")
    return k_cs, d


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
    """The probe's entry point, counted; returns the P1 and P2 rows and the
    L2-resident gather ceiling (P1's rows a second over a 16 MiB table of
    16-B rows: a 32-B sector a row)."""
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
    ceil = gather.measure("per_lane", *gather.TEXTURE_CASE)
    print(f"PT gather ceiling: P1 over a 16 MiB table (the 256^3 uint8 density texture), 16-B rows, "
          f"a lane a row (32 rows a warp step), {gather.TEXTURE_CASE[2]} rows gathered: "
          f"{ceil['mrows_per_s']:.1f} Mrows/s ms={ceil['ms']:.4f}; K4 at 256^3: "
          f"{k4_steps_per_s / 1e6:.1f} Msteps/s (8 texel reads a step)", flush=True)
    designs = gather.variants()
    parts = []
    for case, by_design in designs.items():
        require(all(r["equal"] for r in by_design.values()),
                f"a P1 design's sums differ from the plain version on {case}")
        parts.append(f"{case}: " + ", ".join(
            f"{name} {min(r['ms']):.4f}-{max(r['ms']):.4f}" for name, r in by_design.items()))
    print(f"P1 designs (probes.gather.variants; ms, min-max of 4 turns of 10 index sets; sums equal "
          f"to the plain version; the package runs '8 rows in flight a lane'; before this redesign "
          f"(PERF.md) {PREV_MS['P1']} ms on the 1 GB table): " + "; ".join(parts), flush=True)
    return rows, ceil["mrows_per_s"] * 1e6


def welford_fold(rad: torch.Tensor):
    """Per-sample records [S, N] folded per lane in sample order, with the
    plain loop's expressions → (mean, m2, count) [N]."""
    mean = torch.zeros_like(rad[0])
    m2 = torch.zeros_like(rad[0])
    cnt = torch.zeros_like(rad[0])
    for x in rad:
        cnt = cnt + 1.0
        delta = x - mean
        mean = mean + delta / torch.clamp(cnt, min=1.0)
        m2 = m2 + delta * (x - mean)
    return mean, m2, cnt


def k7b_against_plain(collectors, pt, params, static, pos, dirs, rcfg, bases, gen,
                      deep_from: int = 0) -> dict:
    """K7b at the radiance stage's first update (every point, its replicas)
    from each experiment base of ``bases`` against its plain version: each
    launch's lanes folded from its per-experiment records, and K7B_CHECKED
    records of each, drawn at random, against one-experiment plain runs of
    their lanes with the base sub0 + k (lanes and experiments are
    independent).  ``deep_from`` > 0: half of each launch's checked records
    drawn from its experiments of at least that many bounces, those that
    met Russian roulette.  Tolerance: counts, steps and scatters equal;
    folds within 1e-5 (sum x) and 1e-4 (sum x^2) of the largest; records
    within 1e-5 of the largest.  Returns the first launch's work, the
    checks and the checked lanes."""
    rs = collectors.radiance_static(static)
    n, dev = pos.shape[0], pos.device
    replicas = max(1, rcfg.max_threads // collectors.bucket_size(n))
    launches = rcfg.launches_per_update
    entry = (pos + 0.5 * params.bbox_size).contiguous()
    rids = torch.arange(n, dtype=torch.int64, device=dev)
    out = dict(replicas=replicas, launches=launches, entry=entry, fold_counts_ok=True,
               fold_err=0.0, deep_records=0, deep_checked=0)
    picks = []
    for base0 in bases:
        base = torch.full((n,), base0, dtype=torch.int64, device=dev)
        o, d, ids, sub0 = collectors._lanes(entry, dirs, rids, base, replicas, launches)
        pm, rec = collectors.launch_radiance(params, rs, o, d, ids, sub0, 0, launches)
        if base0 == bases[0]:
            out.update(steps=int(pm.steps.sum()), bounces=int(pm.bounces.sum()), lanes=o.shape[0],
                       counters=[int(v) for v in collectors.radiance_moments.last_counters.tolist()])
        mean_f, m2_f, cnt_f = welford_fold(rec.radiance[..., 0])
        out["fold_counts_ok"] = (out["fold_counts_ok"] and torch.equal(pm.count, cnt_f)
                                 and torch.equal(pm.steps, rec.work[..., 0].long().sum(dim=0))
                                 and torch.equal(pm.bounces, rec.work[..., 1].long().sum(dim=0)))
        for a, b, tol in ((pm.mean[:, 0], mean_f, 1e-5), (pm.m2[:, 0], m2_f, 1e-4)):
            out["fold_err"] = max(out["fold_err"], (a - b).abs().max().item()
                                  / (tol * (b.abs().max().item() + 1e-12)))
        lane = torch.randint(0, o.shape[0], (K7B_CHECKED,), generator=gen)
        exp = torch.randint(0, launches, (K7B_CHECKED,), generator=gen)
        if deep_from > 0:
            deep = torch.nonzero(rec.work[..., 1] >= deep_from).cpu()  # (experiment, lane)
            out["deep_records"] += deep.shape[0]
            if deep.shape[0]:
                half = K7B_CHECKED // 2
                j = torch.randint(0, deep.shape[0], (half,), generator=gen)
                exp[:half], lane[:half] = deep[j, 0], deep[j, 1]
                out["deep_checked"] += half
        lane, exp = lane.to(dev), exp.to(dev)
        picks.append((o[lane], d[lane], ids[lane], (sub0[lane] + exp) & 0xFFFFFFFF,
                      rec.radiance[exp, lane], rec.work[exp, lane].long()))
        del pm, rec
    po, pd, pids, psub, prad, pwork = (torch.cat(t).contiguous() for t in zip(*picks))
    phit = torch.ones(po.shape[0], dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = pt.scatter_loop_plain(params, rs, po, pd, phit, pids, 0, psub, 1)
    torch.cuda.synchronize()
    out["plain_ms"] = (time.perf_counter() - t0) * 1e3
    out["err"] = (prad - one.mean).abs().max().item()
    out["counts_eq"] = (torch.equal(pwork[:, 0], one.steps)
                        and torch.equal(pwork[:, 1], one.bounces))
    out["longest_steps"] = int(one.steps.max())
    out["max_bounces"] = int(one.bounces.max())
    out["ok"] = (out["fold_counts_ok"] and out["fold_err"] <= 1.0 and out["counts_eq"]
                 and out["err"] <= 1e-5 * (one.mean.abs().max().item() + 1e-12))
    out["checked"] = (po, pd, pids, psub)
    return out


def phase_collect(config, cuda_build, collectors, desc_ops, ins_ops, pt, dev,
                  gather_rows_per_s: float) -> list:
    """The dataset generator at the operating point, as a user drives it:
    one SceneSetup in a fresh ``RecordStore``, ``tasks.collect`` over the
    four stages (launch counts set to 0 just before, read just after),
    then the gates against the plain versions.  The store is the train
    store of a ``DatasetTriplet`` in a temporary directory, for the train
    phase.  Returns the K7a and K7b kernel rows, the directory and the
    collected scene (cfg, params, static)."""
    import tempfile

    from deepestscatter_tpu_torch import tasks
    from deepestscatter_tpu_torch.data import records
    from deepestscatter_tpu_torch.data.store import DatasetTriplet

    counters = {"K7a": collectors.generate_scatter_samples, "K7b": collectors.radiance_moments,
                "K2": desc_ops.network_inputs, "K3": ins_ops.sun_transmittance}
    tmp = tempfile.TemporaryDirectory()
    store = DatasetTriplet(tmp.name).train
    setup = np.zeros(1, records.SCENE_SETUP)
    setup[0] = (COLLECT_CLOUD.encode(), COLLECT_SIZE_M, config.LIGHT_DIRECTIONS["Front"])
    store.table("SceneSetup").batch_append(0, setup)
    n = records.BATCH_SIZE
    rcfg = config.PointRadianceConfig()
    secs = {}
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for stage in COLLECT_STAGES:
        t0 = time.time()
        done = tasks.collect(store, stage, tasks.CollectMode.OVERWRITE, radiance_cfg=rcfg,
                             batch_size=n, verbose=False, device=dev)
        torch.cuda.synchronize()
        secs[stage] = time.time() - t0
        require(done == 1, f"collect {stage}: {done} scenes processed")
    launched = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    counts = {stage: store.count(stage) for stage in COLLECT_STAGES}
    print(f"collect: cloud={COLLECT_CLOUD} size_m={COLLECT_SIZE_M} light=Front samples={n} "
          f"stage_s={json.dumps({k: round(v, 3) for k, v in secs.items()})} "
          f"records={json.dumps(counts)} launches={json.dumps(launched)} "
          f"peak_mem_mb={peak / 2**20:.1f}", flush=True)
    require(all(v > 0 for v in launched.values()),
            f"a kernel of the collector's path never launched: {launched}")
    require(all(v == n for v in counts.values()), f"a table does not hold {n} records: {counts}")

    # -- the stored records, and the stages again through the collectors ----
    samples = store.table("ScatterSample").read(0, n)
    norms = np.linalg.norm(samples["view_direction"], axis=1)
    stored = store.table("Result").read(0, n)
    labels = stored["light_intensity"]
    sets = store.table("BakedInterpolationSet").read(0, n)
    power_err = float(np.abs(sum(sets[c]["power"] for c in "abcd") - 1.0).max())
    scene_cfg, params, static = tasks.scene_from_setup(store.table("SceneSetup").get_record(0),
                                                       device=dev)
    pos = torch.as_tensor(samples["point"], device=dev)
    dirs = torch.as_tensor(samples["view_direction"], device=dev)
    k = collectors.generate_scatter_samples(params, static, n, 0)
    require(np.array_equal(k.positions.cpu().numpy(), samples["point"])
            and np.array_equal(k.directions.cpu().numpy(), samples["view_direction"]),
            "collect: K7a again gave other samples than those stored")
    print(f"collect samples: found={int(k.found.sum())}/{n} attempts_mean="
          f"{k.attempts.float().mean().item():.3f} attempts_max={int(k.attempts.max())} "
          f"march_steps={int(k.steps.sum())}", flush=True)
    est = collectors.estimate_point_radiance(params, static, pos, dirs, rcfg, seed=0)
    require(np.array_equal(est.radiance, labels)
            and np.array_equal(est.is_converged.astype(np.uint8), stored["is_converged"]),
            "collect: the stored labels differ from estimate_point_radiance's")
    exps, sched = est.experiments, est.schedule
    black = int((est.radiance < np.finfo(np.float32).eps).sum())
    print(f"collect radiance: updates={len(sched)} converged={int(est.is_converged.sum())}/{n} "
          f"black={black} experiments_min={int(exps.min())} median={int(np.median(exps))} "
          f"max={int(exps.max())} label_mean={float(est.radiance.mean()):.6g} "
          f"schedule(active, replicas)={json.dumps(sched[:4])}..{json.dumps(sched[-3:])} "
          f"(labels and convergence flags equal to the stored ones)", flush=True)
    print(f"collect records: point_abs_max={float(np.abs(samples['point']).max()):.4f} "
          f"direction_norm_err={float(np.abs(norms - 1.0).max()):.3g} labels_finite="
          f"{bool(np.isfinite(labels).all())} labels_min={float(labels.min()):.4g} "
          f"labels_mean={float(labels.mean()):.6g} power_sum_err={power_err:.3g} (tol 1e-4)",
          flush=True)
    bbox = params.bbox_size.cpu().numpy()
    local = samples["point"] + 0.5 * bbox
    inside = bool(((local >= -0.01) & (local <= bbox + 0.01)).all())
    require(bool(k.found.all()) and inside and float(np.abs(norms - 1.0).max()) <= 1e-5,
            "collect: a sample lies outside the box or its direction is not a unit vector")
    require(bool(np.isfinite(labels).all()) and float(labels.min()) >= 0.0
            and float(labels.mean()) > 0.0, "collect: labels not finite, negative or all zero")
    require(power_err <= 1e-4, "collect: baked powers do not sum to 1")

    # K3 on the collector's scene (the padded grid, the Front light): bitwise.
    k3 = ins_ops.sun_transmittance(params, static)
    p3 = ins_ops.sun_transmittance_plain(params, static)
    err3 = (k3 - p3).abs().max().item()
    print(f"K3 collector bake: grid={static.grid_shape} light={static.light_direction} "
          f"max_abs_err={err3:.3g} (tol 0)", flush=True)
    require(err3 == 0.0, "K3 disagrees with its plain version on the collector's scene")

    # K7a against its plain version on the card, on the stage's scene.
    t0 = time.perf_counter()
    r = collectors.generate_scatter_samples_plain(params, static, n, 0)
    torch.cuda.synchronize()
    plain_a = (time.perf_counter() - t0) * 1e3
    agree = (k.found == r.found).float().mean().item()
    att_agree = (k.attempts == r.attempts).float().mean().item()
    same = (k.attempts == r.attempts) & k.found & r.found
    err_a = (k.positions - r.positions)[same].abs().max().item()
    bit_a = (same & (k.positions == r.positions).all(dim=-1)).float().mean().item()
    steps_equal = torch.equal(k.steps, r.steps)
    unequal = [f for f, a, b in zip(r._fields, k, r) if not torch.equal(a, b)]
    ms_a = device_ms(lambda: collectors.generate_scatter_samples(params, static, n, 0), 10,
                     "samples_rounds_kernel")
    steps_a, att_a = int(k.steps.sum()), int(k.attempts.sum())
    w = cuda_build.load("samples").ds_sample_warps()
    rounds = (k.attempts + w - 1) // w
    work_a = dict(warps_a_sample=w, attempts_mean=float(k.attempts.float().mean()),
                  attempts_max=int(k.attempts.max()), rounds_mean=float(rounds.float().mean()),
                  rounds_max=int(rounds.max()))
    print(f"K7a scatter samples: samples={n} found_agree={agree:.6f} "
          f"attempts_agree={att_agree:.6f} pos_max_abs_err={err_a:.3g} "
          f"bitwise_share={bit_a:.6f} steps_equal={steps_equal} "
          f"fields_not_bitwise_equal={unequal} (required: none) "
          f"ms(device, profiler)={ms_a:.4f} before_redesign_ms(PERF.md)={PREV_MS['K7a']} "
          f"plain_ms={plain_a:.1f} attempts={att_a} steps={steps_a} {json.dumps(work_a)}",
          flush=True)
    require(not unequal, f"K7a differs from its plain version in {unequal}")
    tex = params.density_mips[0].numel() * params.density_mips[0].element_size()
    row_a = kernel_row("K7a first-scatter sampler", "deepestscatter_tpu_torch/csrc/samples.cu",
                       "deepestscatter_tpu/data/collectors.py:59", err_a, ms_a, plain_a,
                       tex + n * (12 + 12 + 1 + 8),
                       steps_a * K7A_OPS_PER_STEP + att_a * K7A_OPS_PER_ATTEMPT)
    row_a.update(work_a)

    # K7b at the radiance stage's first update, from bases 0 and 2^32 - 50
    # (every lane's experiments wrap past 2^32).
    rs = collectors.radiance_static(static)
    gen = torch.Generator().manual_seed(7)
    kb = k7b_against_plain(collectors, pt, params, static, pos, dirs, rcfg, (0, 2**32 - 50), gen)
    replicas, launches, n_lanes = kb["replicas"], kb["launches"], kb["lanes"]
    steps_b, bounces_b = kb["steps"], kb["bounces"]
    items, slots, resolves, resolved = kb["counters"]
    fold_counts_ok, fold_err, counts_eq, err_b = (kb[k] for k in ("fold_counts_ok", "fold_err",
                                                                   "counts_eq", "err"))
    po, pd, pids, psub = kb["checked"]
    plain_b = kb["plain_ms"]
    ms_checked = time_ms(lambda: collectors.launch_radiance(params, rs, po, pd, pids, psub, 0, 1),
                         3)
    args = (params, rs, kb["entry"], dirs, torch.arange(n, dtype=torch.int64, device=dev),
            torch.zeros(n, dtype=torch.int64, device=dev), 0, replicas, launches)
    ms_b = time_ms(lambda: collectors.radiance_moments(*args), 3)
    simt_b = steps_b / max(32.0 * slots, 1.0)
    work_b = dict(steps_per_s=steps_b / (ms_b * 1e-3), simt_efficiency=simt_b,
                  crossings_per_resolve_step=resolved / max(resolves, 1))
    # A step's 8 taps lie in 4 (y, z) rows of the uint8 [Z, Y, X] texture:
    # ~4 sectors of 32 B a step, were every tap to miss L1.
    sectors_per_s = 4.0 * work_b["steps_per_s"]
    print(f"K7b radiance experiments: points={n} replicas={replicas} launches={launches} "
          f"lanes={n_lanes} experiments={n_lanes * launches} steps={steps_b} "
          f"bounces={bounces_b} simt_efficiency={simt_b:.4f} (steps / (32 x march slots)) "
          f"resolve_steps={resolves} crossings_resolved={resolved} "
          f"crossings_per_resolve_step={work_b['crossings_per_resolve_step']:.2f} "
          f"park_at={cuda_build.load('pathtrace').ds_radiance_park_at()} "
          f"ms={ms_b:.3f} before_redesign_ms(PERF.md)={PREV_MS['K7b']} "
          f"steps_per_s={work_b['steps_per_s']:.4g} tap_sectors_per_s(4 a step, were every tap "
          f"to miss L1)={sectors_per_s:.4g} against the L2 gather ceiling (P1, 16-B rows, "
          f"16 MiB)={gather_rows_per_s:.4g} rows/s; bases 0 and 2^32 - 50: "
          f"folds_equal_records(counts, steps, "
          f"scatters)={fold_counts_ok} fold_err(of tol sum x 1e-5, sum x^2 1e-4 of max)="
          f"{fold_err:.3g}; {po.shape[0]} records against one-experiment plain runs: "
          f"steps_scatters_equal={counts_eq} max_abs_err={err_b:.3g} (tol 1e-5 of "
          f"max) longest_steps={kb['longest_steps']} plain_ms={plain_b:.1f} "
          f"kernel_ms(same experiments)={ms_checked:.3f}", flush=True)
    require(kb["ok"], "K7b disagrees with its plain version")
    tables = (params.phase.eval_rows.numel() + params.phase.inv_cdf_rows.numel()) * 4
    row_b = kernel_row("K7b radiance experiments", "deepestscatter_tpu_torch/csrc/pathtrace.cu",
                       "deepestscatter_tpu/data/collectors.py:150", err_b, ms_b, plain_b,
                       2 * tex + tables + n_lanes * (12 + 12 + 8 + 4) + n_lanes * (12 + 12 + 4 + 16),
                       steps_b * K4_OPS_PER_STEP + bounces_b * K4_OPS_PER_BOUNCE
                       + n_lanes * launches * K4_OPS_PER_SAMPLE)
    row_b.update(work_b)

    # The stored grids against K2's plain version (bitwise).
    grids = store.table("DisneyDescriptor").read(0, n)["grid"]
    pgrids = plain_descriptors(desc_ops, collectors.collect_disney_descriptors, params, static,
                               pos, dirs)
    psets = plain_descriptors(desc_ops, collectors.collect_baked_sets, params, static, pos)
    same_sets = all(np.array_equal(sets[c][f], psets[c][f]) for c in "abcd"
                    for f in ("grid", "position", "power"))
    print(f"collect descriptors: disney_grids_equal_plain_K2={np.array_equal(grids, pgrids)} "
          f"baked_sets_equal_plain_K2={same_sets} grid_mean={float(grids.mean()):.4f}", flush=True)
    require(np.array_equal(grids, pgrids) and same_sets,
            "collect: descriptor grids differ from K2's plain version")
    store.close()
    return ([dict(row_a, launches=launched["K7a"]), dict(row_b, launches=launched["K7b"])], tmp,
            (scene_cfg, params, static))


#: The training phase: steps of each trainer on the main path (an epoch of
#: the ~1,938 converged labels is one step of 1,024), steps a timed chunk,
#: the card-against-CPU steps and the resumed run's epochs.
TRAIN_EPOCHS = 40
TRAIN_CHUNK = 10
TRAIN_CPU_STEPS = 5
RESUME_EPOCHS = 8
TRAIN_WARNING = "WARNING: validation store has no complete labels"


def k10_bytes(data, b: int, layout: str) -> int:
    """The bytes K10 must move for a batch of ``b``: each gathered row and
    index read once, each output written once."""
    if layout == "disney":
        row_in = data.grids.shape[1] + 4 + 4
        row_out = data.grids.shape[1] // 225 * 226 * 4 + 4
    else:
        row_in = data.probes.shape[1] + data.rt.shape[1] + 16 + 12
        row_out = (data.probes.shape[1] + data.rt.shape[1] // 225 * 226) * 4 + 16 + 12
    return b * (row_in + 8 + row_out)


def phase_k10(dd, data, layout: str, idx) -> dict:
    """K10 against its plain version on the card, bitwise, at the batch
    ``idx`` of the collected tables; its device time (profiler), its back-
    to-back CUDA-event time, the plain version's time and the device time
    of the PyTorch chain (index_select, float, div, cat)."""
    k_item, k_lab = data.assemble(idx)
    p_item, p_lab = data.assemble_plain(idx)
    torch.cuda.synchronize()
    same = torch.equal(k_lab, p_lab) and all(torch.equal(k_item[k], p_item[k]) for k in p_item)
    err = max([(k_item[k] - p_item[k]).abs().max().item() for k in p_item]
              + [(k_lab - p_lab).abs().max().item()])
    kernel = f"assemble_{layout}_kernel"
    ms = device_ms(lambda: data.assemble(idx), 20, kernel, cold=True)
    warm_ms = device_ms(lambda: data.assemble(idx), 20, kernel)
    ev_ms = time_ms(lambda: data.assemble(idx), 20)
    plain_ms = time_ms(lambda: data.assemble_plain(idx), 20)
    chain_ms = device_ms(lambda: data.assemble_plain(idx), 20, cold=True)
    chain_warm = device_ms(lambda: data.assemble_plain(idx), 20)
    n_bytes = k10_bytes(data, idx.shape[0], layout)
    label = {"disney": "RPNN", "baked": "baked"}[layout]
    print(f"K10 batch assembly ({label}): batch={idx.shape[0]} outputs="
          f"{json.dumps({k: list(v.shape) for k, v in k_item.items()})} bitwise_equal_plain={same} "
          f"max_abs_err={err:.3g} (tol 0) ms(device, profiler, L2 flushed)={ms:.4f} "
          f"ms(device, back to back: L2-warm)={warm_ms:.4f} ms(CUDA events, back-to-back "
          f"calls)={ev_ms:.4f} plain_ms(CUDA events)={plain_ms:.4f} chain_ms(index_select+"
          f"float+div+cat, device, L2 flushed)={chain_ms:.4f} chain_ms(L2-warm)={chain_warm:.4f} "
          f"bytes={n_bytes} bound_ms={n_bytes / HBM_BYTES_PER_S * 1e3:.4f}", flush=True)
    require(same, f"K10 ({label}) differs from its plain version")
    line = {"disney": ":86", "baked": ":143"}[layout]
    return kernel_row(f"K10 batch assembly ({label})", "deepestscatter_tpu_torch/csrc/assemble.cu",
                      "deepestscatter_tpu/train/device_data.py" + line, err, ms, plain_ms, n_bytes,
                      0, library_ms=chain_ms)


def read_metrics(run_dir: str, tag: str):
    with open(Path(run_dir) / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [r["value"] for r in rows if r["tag"] == tag]


def train_profile(label: str, tr, t, idx) -> dict:
    """ms a step (median over synchronized chunks of TRAIN_CHUNK steps) and
    one chunk's device time by kernel: the GEMMs' share and the idle share
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    chunk = lambda: tr.chunk_step(t.model, t.opt, t.apply_fn, t.device_data.assemble, idx)  # noqa: E731
    chunk()
    per_step = sorted(host_ms(chunk) / idx.shape[0] for _ in range(5))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    require(bool(evs), f"{label}: the profiler saw no device time")
    evs.sort(key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    gemm = sum(e.self_device_time_total for e in evs
               if any(w in e.key.lower() for w in ("gemm", "xmma", "cutlass"))) / 1e3
    k10 = sum(e.self_device_time_total for e in evs if "assemble_" in e.key) / 1e3
    top = [[e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count] for e in evs[:10]]
    step_dev = dev_ms / idx.shape[0]
    out = dict(ms_per_step_median=per_step[2], ms_per_step_all=[round(v, 3) for v in per_step],
               device_ms_per_step=step_dev, gemm_share=gemm / dev_ms, k10_share=k10 / dev_ms,
               idle_share_vs_unprofiled=1.0 - step_dev / per_step[2],
               idle_share_profiled=1.0 - dev_ms / wall)
    print(f"{label} profile: steps_a_chunk={idx.shape[0]} {json.dumps(out)} top={json.dumps(top)}",
          flush=True)
    return out


def frame_gates(label: str, renderer, params, static, basis, random_frame):
    """The exported weights' frames: ``check_frames`` on seeds 2 and 3 and
    seed 2 again, and the seed-2 frame unlike the random weights' one."""
    render = lambda seed: renderer.render_frame(params, static, WIDTH, HEIGHT, basis, seed=seed)  # noqa: E731
    frames = [render(2), render(3)]
    again = render(2)
    check_frames(label, frames + [again], again, frames)
    differs = not torch.equal(frames[0], random_frame)
    print(f"{label}: seeds 2, 3 mean={frames[0].mean().item():.6f}, {frames[1].mean().item():.6f} "
          f"random_weights_mean={random_frame.mean().item():.6f} differs_from_random={differs}",
          flush=True)
    require(differs, f"{label}: the trained frame equals the random weights' frame")


def phase_train(port, root: str, collected, dev) -> list:
    """Training on the collected store the way a user trains: the RPNN
    (``entries.train_disney``) and the baked model (``entries.train_baked``)
    on the card with device-resident batches (K10), at full width on the
    reference recipe (batch 1,024, validation every 40 steps, lr 1e-3) for
    TRAIN_EPOCHS epochs of one step, the validation store empty (its WARNING
    must appear).  Launch counts are set to 0 just before the two runs and
    read just after; K10 must have launched in both layouts.  Gates: every
    loss finite, the final validation loss below the initial one's; K10
    bitwise equal to its plain version at a batch of 1,024; against the CPU
    (the same ``flax_init`` weights, TRAIN_CPU_STEPS steps on the same
    schedule, the plain version there): each step's loss within a relative
    1e-4 (cuBLAS and the CPU sum in other orders), the optimizer's updates
    from identical gradients within a relative 1e-6 (elementwise float32
    arithmetic on both, but PyTorch's vectorized CPU ``sqrt`` is not
    correctly rounded on ~0.7 % of inputs); a run stopped after one chunk and
    restored into a fresh trainer equal, bitwise, to the uninterrupted run;
    the exports (``DisneyModel.pt``; ``LightProbeModel.pt`` and
    ``ProbeRendererModel.pt``) loaded into ``DisneyRenderer`` and
    ``BakedRenderer`` render the collected scene (``check_frames``), each
    frame unlike the random weights' frame of that seed.  Returns K10's two
    kernel rows."""
    import contextlib
    import io

    from deepestscatter_tpu_torch import config
    from deepestscatter_tpu_torch.models.probes import (LightProbeModel, ProbeRendererModel,
                                                        init_light_probe_model,
                                                        init_probe_renderer_model)
    from deepestscatter_tpu_torch.models.rpnn import DisneyModel, init_disney_model
    from deepestscatter_tpu_torch.render import camera as cam
    from deepestscatter_tpu_torch.train import device_data as dd
    from deepestscatter_tpu_torch.train import entries
    from deepestscatter_tpu_torch.train import trainer as tr

    scene_cfg, params, static = collected
    runs = Path(root) / "runs"
    cfg = config.TrainConfig(run_dir=str(runs / "main"))
    make_trainer = {"DisneyModel": entries.disney_trainer, "BakedModel": entries.baked_trainer}

    # -- the initial validation losses (flax_init is deterministic per seed) --
    initial = {}
    for name, build in make_trainer.items():
        with contextlib.redirect_stdout(io.StringIO()):
            t = build(root, dataclasses.replace(cfg, run_dir=str(runs / "initial")),
                      device_resident=True, device=dev)
        initial[name] = t.val_loss()
        del t

    # -- the main path, counted ------------------------------------------------
    counters = {"disney": dd.assemble_disney, "baked": dd.assemble_baked}
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, trained, logs = {}, {}, {}
    for name, entry in (("DisneyModel", entries.train_disney),
                        ("BakedModel", entries.train_baked)):
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            trained[name] = entry(root, cfg, epochs=TRAIN_EPOCHS, device_resident=True,
                                  device=dev)
        torch.cuda.synchronize()
        secs[name] = time.time() - t0
        logs[name] = buf.getvalue().splitlines()
    launched = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for name, t in trained.items():
        train_l, val_l = read_metrics(t.run_dir, "train_loss"), read_metrics(t.run_dir, "val_loss")
        warned = [ln for ln in logs[name] if TRAIN_WARNING in ln]
        finite = bool(np.isfinite(train_l).all() and np.isfinite(val_l).all())
        print(f"train {name}: entry=train_{'disney' if name == 'DisneyModel' else 'baked'}"
              f"(device_resident=True) steps={t.step} labels_pool={len(t.device_data.pool())} "
              f"batch={cfg.batch_size} lr={cfg.learning_rate} validations={len(val_l)} "
              f"seconds={secs[name]:.2f} val_loss_initial={initial[name]:.6f} "
              f"val_loss_final={val_l[-1]:.6f} best_val={t.best_val:.6f} train_loss_first="
              f"{train_l[0]:.6f} train_loss_last={train_l[-1]:.6f} finite={finite} "
              f"warning_lines={len(warned)} ({warned[0].strip() if warned else 'none'})",
              flush=True)
        require(t.step >= TRAIN_EPOCHS, f"train {name}: {t.step} steps, fewer than {TRAIN_EPOCHS}")
        require(finite, f"train {name}: a loss is not finite")
        require(val_l[-1] < initial[name], f"train {name}: the final validation loss "
                f"{val_l[-1]} is not below the initial {initial[name]}")
        require(bool(warned), f"train {name}: the validation fallback's WARNING did not appear")
    print(f"train launches: {json.dumps(launched)} (K10 a step and a validation) "
          f"peak_mem_mb={peak / 2**20:.1f}", flush=True)
    require(all(v > 0 for v in launched.values()),
            f"K10 never launched on the training path: {launched}")

    # -- K10 against its plain version, and the step's time by kernel --------
    rows = []
    for name, layout in (("DisneyModel", "disney"), ("BakedModel", "baked")):
        t = trained[name]
        pool = t.device_data.pool()
        idx = torch.as_tensor(dd.epoch_schedule(pool, cfg.batch_size, cfg.seed, 0)[0],
                              dtype=torch.int64, device=dev)
        rows.append(dict(phase_k10(dd, t.device_data, layout, idx), launches=launched[layout]))
        sched = np.concatenate([dd.epoch_schedule(pool, cfg.batch_size, cfg.seed, e)
                                for e in range(TRAIN_CHUNK)])[:TRAIN_CHUNK]
        with contextlib.redirect_stdout(io.StringIO()):
            timed = make_trainer[name](root, dataclasses.replace(cfg, run_dir=str(runs / "timed")),
                                   device_resident=True, device=dev)
        train_profile(f"train {name}", tr, timed,
                      torch.as_tensor(sched, dtype=torch.int64, device=dev))
        del timed

    # -- card against CPU: the same initial weights and schedule --------------
    for name in make_trainer:
        with contextlib.redirect_stdout(io.StringIO()):
            tc = make_trainer[name](root, dataclasses.replace(cfg, run_dir=str(runs / "card")),
                                device_resident=True, device=dev)
            tp = make_trainer[name](root, dataclasses.replace(cfg, run_dir=str(runs / "cpu")),
                                device_resident=True, device="cpu")
        same_init = torch.equal(tr.flat_params(tc.model).cpu(), tr.flat_params(tp.model))
        sched = np.concatenate([dd.epoch_schedule(tc.device_data.pool(), cfg.batch_size,
                                                  cfg.seed, e) for e in range(TRAIN_CPU_STEPS)]
                               )[:TRAIN_CPU_STEPS]
        idx = torch.as_tensor(sched, dtype=torch.int64)
        lc = tr.chunk_step(tc.model, tc.opt, tc.apply_fn, tc.device_data.assemble,
                           idx.to(dev)).cpu()
        lp = tr.chunk_step(tp.model, tp.opt, tp.apply_fn, tp.device_data.assemble, idx)
        rel = ((lc - lp).abs() / lp.abs()).max().item()
        # The optimizer rule alone: the CPU's gradients on both devices.
        batch, labels = tp.device_data.assemble(idx[0])
        loss = tr.log_mse_loss(tp.apply_fn(tp.model, batch)[:, 0], labels)
        grads = torch.autograd.grad(loss, tp.opt.params)
        oc = tr.AmsGrad([p.detach().to(dev) for p in tp.opt.params], cfg.learning_rate)
        op = tr.AmsGrad([p.detach().clone() for p in tp.opt.params], cfg.learning_rate)
        upd_rel, upd_bitwise = 0.0, True
        for _ in range(3):
            uc = oc.updates([g.to(dev) for g in grads]).cpu()
            up = op.updates(grads)
            upd_rel = max(upd_rel, ((uc - up).abs() / up.abs().clamp(min=1e-30)).max().item())
            upd_bitwise = upd_bitwise and torch.equal(uc, up)
        print(f"train card vs cpu {name}: same_initial_weights={same_init} steps="
              f"{TRAIN_CPU_STEPS} card_losses={[round(v, 6) for v in lc.tolist()]} "
              f"cpu_losses={[round(v, 6) for v in lp.tolist()]} loss_max_rel_err={rel:.3g} "
              f"(tol 1e-4) amsgrad_update_max_rel_err={upd_rel:.3g} (tol 1e-6) "
              f"amsgrad_bitwise={upd_bitwise}", flush=True)
        require(same_init, f"train card vs cpu {name}: the initial weights differ")
        require(rel <= 1e-4, f"train card vs cpu {name}: a step's loss beyond 1e-4")
        require(upd_rel <= 1e-6, f"train card vs cpu {name}: the amsgrad update beyond 1e-6")
        del tc, tp

    # -- resume: stopped after one chunk, restored, continued -----------------
    with contextlib.redirect_stdout(io.StringIO()):
        whole = entries.train_disney(root, dataclasses.replace(cfg, run_dir=str(runs / "whole")),
                                     epochs=RESUME_EPOCHS, device_resident=True, device=dev)
        cut_cfg = dataclasses.replace(cfg, run_dir=str(runs / "cut"))
        first = entries.train_disney(root, cut_cfg, epochs=1, device_resident=True, device=dev)
        resumed = entries.disney_trainer(root, cut_cfg, device_resident=True, device=dev)
        restored = resumed.restore()
        resumed.run(epochs=RESUME_EPOCHS)
    a, b = tr.flat_params(resumed.model), tr.flat_params(whole.model)
    bitwise = torch.equal(a, b) and all(torch.equal(getattr(resumed.opt, k), getattr(whole.opt, k))
                                        for k in ("mu", "nu", "nu_max"))
    print(f"train resume: stopped_at_step={first.step} restored={restored} "
          f"resumed_to_step={resumed.step} uninterrupted_step={whole.step} "
          f"params_and_moments_bitwise={bitwise} params_max_abs_diff={(a - b).abs().max().item():.3g}",
          flush=True)
    require(restored and resumed.step == whole.step and bitwise,
            "train resume: the resumed run differs from the uninterrupted one")
    del whole, first, resumed

    # -- the exports render the collected scene --------------------------------
    basis = cam.camera_basis(scene_cfg.camera)
    run_d = Path(trained["DisneyModel"].run_dir)
    run_b = Path(trained["BakedModel"].run_dir)
    load = lambda m, path: (m.load_state_dict(torch.load(path, weights_only=True), strict=True),  # noqa: E731
                            m.to(dev).eval())[1]
    nn_model = load(DisneyModel(), run_d / "DisneyModel.pt")
    rand = port.DisneyRenderer(init_disney_model(SEED_WEIGHTS, device=dev), device=dev)
    frame_gates("train NN frame (DisneyModel.pt)", port.DisneyRenderer(nn_model, device=dev),
                params, static, basis,
                rand.render_frame(params, static, WIDTH, HEIGHT, basis, seed=2))
    lpm = load(LightProbeModel(), run_b / "LightProbeModel.pt")
    prm = load(ProbeRendererModel(), run_b / "ProbeRendererModel.pt")
    rand = port.BakedRenderer(params, static, init_light_probe_model(SEED_WEIGHTS, device=dev),
                              init_probe_renderer_model(SEED_WEIGHTS, device=dev), device=dev)
    frame_gates("train BNN frame (LightProbeModel.pt, ProbeRendererModel.pt)",
                port.BakedRenderer(params, static, lpm, prm, device=dev), params, static,
                basis, rand.render_frame(params, static, WIDTH, HEIGHT, basis, seed=2))
    return rows


def phase_ground_truth(prog, pt, ins_ops, dev) -> None:
    """The port's converged renders of the evaluation's held-out scene
    against the JAX package's committed one; counted (K3, K4)."""
    from deepestscatter_tpu_torch import tasks
    from deepestscatter_tpu_torch.utils import compare, exr

    record = json.loads(EVAL_JSON.read_text())
    width, height = record["resolution"]
    reference = exr.read_exr(str(EVAL_REFERENCE))
    for f in (pt.scatter_loop, ins_ops.sun_transmittance):
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    setup, base = tasks.eval_scene(record["held_out_scene"], width, height)
    cfg, params, static = tasks.scene_from_setup(setup, base, device=dev)
    setup_s = time.time() - t0
    # The first 20 subframes at the reference's seed against the JAX
    # package's on the CPU: the same paths, but where the two parted.
    jax_cpu = exr.read_exr(str(EVAL_JAX_CPU)).astype(np.float64)
    short = prog.ProgressiveRenderer(cfg, params, static, seed=EVAL_REFERENCE_SEED, device=dev)
    while short.state.subframe_id < EVAL_JAX_CPU_SUBFRAMES:
        short.tick()
    got = short.hdr_image().astype(np.float64)
    close = float((np.abs(got - jax_cpu) <= 1e-3 * np.maximum(np.abs(jax_cpu), 1e-6)).mean())
    bitwise = float((got == jax_cpu).mean())
    mean_rel = abs(got.mean() - jax_cpu.mean()) / jax_cpu.mean()
    diff, paired_se = compare.paired_difference(got, jax_cpu)
    print(f"JAX ground truth, first {EVAL_JAX_CPU_SUBFRAMES} subframes of seed "
          f"{EVAL_REFERENCE_SEED} against the JAX package on the CPU: "
          f"subframes={short.state.subframe_id} channels_within_1e-3={close:.6f} (tol 0.98) "
          f"bitwise_share={bitwise:.6f} image_mean={got.mean():.6f} "
          f"jax_cpu_mean={jax_cpu.mean():.6f} mean_rel_diff={mean_rel:.3g} (tol 1e-4) "
          f"diff={diff:.4g} paired_se={paired_se:.3g} paired_z={diff / paired_se:.3f}",
          flush=True)
    require(close >= 0.98 and mean_rel <= 1e-4,
            "the port's first subframes disagree with the JAX package's on the CPU")
    # The reference's seed to its depth and a tick either side: the same
    # paths as the file's, but where the TPU's float functions parted them.
    ref_t = torch.as_tensor(reference, device=dev).reshape(-1, 3)
    r3 = prog.ProgressiveRenderer(cfg, params, static, seed=EVAL_REFERENCE_SEED, device=dev)
    tick = cfg.progressive.subframes_per_tick
    mad = {}
    for sub in (EVAL_REFERENCE_SUBFRAMES - tick, EVAL_REFERENCE_SUBFRAMES,
                EVAL_REFERENCE_SUBFRAMES + tick):
        while r3.state.subframe_id < sub:
            r3.tick()
        require(r3.state.subframe_id == sub, f"seed {EVAL_REFERENCE_SEED} missed subframe {sub}")
        mad[sub] = float((r3.state.mean - ref_t).abs().mean())
        if sub == EVAL_REFERENCE_SUBFRAMES:
            at_depth = r3.hdr_image()
    depth_ok = mad[EVAL_REFERENCE_SUBFRAMES] < min(
        v for k, v in mad.items() if k != EVAL_REFERENCE_SUBFRAMES)
    diff3, se3 = compare.paired_difference(at_depth, reference)
    sdiff3, sse3 = compare.paired_difference(EVAL_SCALE * at_depth, reference)
    print(f"JAX ground truth, seed {EVAL_REFERENCE_SEED} at the reference's "
          f"{EVAL_REFERENCE_SUBFRAMES} subframes: mean_abs_diff="
          f"{json.dumps({k: round(v, 6) for k, v in mad.items()})} (least at "
          f"{EVAL_REFERENCE_SUBFRAMES} required) image_mean={at_depth.astype(np.float64).mean():.6f} "
          f"reference_mean={reference.astype(np.float64).mean():.6f} diff={diff3:.4g} "
          f"rel_diff={diff3 / reference.astype(np.float64).mean():.3g} paired_se={se3:.3g} "
          f"paired_z={diff3 / se3:.3f} (tol {compare.Z_MAX:g}) "
          f"tone_mapped_rms={compare.rms_bias(reference, at_depth):.6g}; scaled by {EVAL_SCALE}: "
          f"paired_z={sdiff3 / sse3:.1f} (must exceed {compare.Z_MAX:g})", flush=True)
    require(depth_ok, "the reference's seed does not come closest to it at its recorded depth")
    require(abs(diff3) <= compare.Z_MAX * se3,
            "the port's render of the reference's seed disagrees with the reference")
    require(abs(sdiff3) > compare.Z_MAX * sse3,
            "the same-seed gate passes an image scaled by 2 %")
    renders, run_s, subframes = [], 0.0, []
    for seed in EVAL_SEEDS:
        r = prog.ProgressiveRenderer(cfg, params, static, seed=seed, device=dev)
        t0 = time.time()
        hdr = r.run()
        torch.cuda.synchronize()
        run_s += time.time() - t0
        st = r.state
        require(bool(np.isfinite(hdr).all()) and hdr.shape == reference.shape,
                f"the ground-truth render of seed {seed} is not finite or has the wrong shape")
        renders.append((st.mean.reshape(height, width, 3).cpu().numpy(),
                        st.m2.reshape(height, width, 3).cpu().numpy(),
                        st.count.reshape(height, width).cpu().numpy()))
        one = compare.render_agreement(
            *renders[-1], reference,
            reference_noise=float(np.sqrt(st.subframe_id / EVAL_REFERENCE_SUBFRAMES)))
        subframes.append(st.subframe_id)
        print(f"JAX ground truth, seed {seed}: subframes={st.subframe_id} "
              f"unconverged={int(prog.unconverged_count(st, cfg.progressive))} "
              f"image_mean={one.mean:.6f} mean_se={one.mean_se:.3g} mean_z={one.mean_z:.3f} "
              f"tone_mapped_rms={one.rms:.6g} noise_expected_rms={one.noise_rms:.6g} "
              f"past_4_sigma_share={one.past_4_sigma:.6f}", flush=True)
    launches = {"K4": pt.scatter_loop.launches, "K3": ins_ops.sun_transmittance.launches}
    mean, m2, count = compare.pool_renders(renders)
    noise = float(np.sqrt(sum(subframes) / EVAL_REFERENCE_SUBFRAMES))
    a = compare.render_agreement(mean, m2, count, reference, reference_noise=noise)
    scaled = compare.render_agreement(EVAL_SCALE * mean, EVAL_SCALE**2 * m2, count, reference,
                                      reference_noise=noise)
    diff = a.mean - a.reference_mean
    rays = width * height * sum(subframes)
    print(f"JAX ground truth: scene={json.dumps(record['held_out_scene'])} {width}x{height} "
          f"seeds={list(EVAL_SEEDS)} pooled setup_s={setup_s:.2f} run_s={run_s:.2f} "
          f"subframes={subframes} Mrays_per_s={rays / run_s / 1e6:.2f} "
          f"image_mean={a.mean:.6f} reference_mean={a.reference_mean:.6f} (EVAL_r05.json "
          f"pt_mean {record['pt_mean']:.5f}) diff={diff:.4g} rel_diff={diff / a.reference_mean:.3g} "
          f"mean_se={a.mean_se:.3g} pooled_mean_z={a.mean_z:.3f} (tol 4) "
          f"tone_mapped_rms={a.rms:.6g} noise_expected_rms={a.noise_rms:.6g} (tol 1.5x) "
          f"past_4_sigma_share={a.past_4_sigma:.6f} launches={json.dumps(launches)}; "
          f"scaled by {EVAL_SCALE}: mean_z={scaled.mean_z:.1f} tone_mapped_rms={scaled.rms:.6g} "
          f"noise_expected_rms={scaled.noise_rms:.6g} passes={scaled.passes()} (must be False)",
          flush=True)
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the ground-truth render never launched: {launches}")
    require(a.passes(), "the port's render disagrees with the JAX package's ground truth")
    require(not scaled.passes(), "the ground-truth gate passes an image scaled by 2 %")


#: The end-to-end quality check's gates: each trained frame's RMS at most
#: EVAL_RANDOM_RATIO of the untrained weights' in the same run, and at most
#: EVAL_BAR times EVAL_r05's (the JAX package's: NN 0.0569, BNN 0.0596).
EVAL_RANDOM_RATIO = 0.6
EVAL_BAR = 1.5
#: The kernels the evaluation's path must launch, by counter.
EVAL_KERNELS = ("K3", "K7a", "K7b", "K2", "K10", "K1", "K5")
#: The evaluation's frame seed (``eval_e2e.run_eval``'s ``render_seed``).
EVAL_RENDER_SEED = 3
#: The command-line phase's render: EVAL_r05's held-out cloud and size.
CLI_ARGS = ("procedural:64:29", "--size-m", "2677.73", "--directions", "Side")


def phase_eval(collectors, desc_ops, ins_ops, march_ops, pt, bnn, dev):
    """The end-to-end quality check (D5) at EVAL_r05's operating point, the
    way a user runs it (``eval_e2e.run_r05``): the round-5 stores
    (``seed_r05``) in a temporary directory, the four stages on train scene
    0 (2,048 samples; the validation store keeps its 4 setups and no
    labels, so the fallback's WARNING must appear), 200 RPNN and 100 baked
    epochs, the NN and BNN frames of the held-out scene at 512 x 256, seed
    3, trained and untrained, each against the committed ``eval.PT.exr``
    (read, never rendered).  Launch counts are set to 0 just before and
    read just after; every kernel of EVAL_KERNELS must have launched.
    Then its kernels against their plain versions at its shapes and
    settings (``eval_against_plain``).  Gates: every frame finite; trained
    RMS <= EVAL_RANDOM_RATIO x the untrained one's (EVAL_r05: 0.38, 0.44)
    and <= EVAL_BAR x EVAL_r05's (NN <= 0.0854, BNN <= 0.0894).  Returns
    the run directory of the trained exports and the temporary
    directory."""
    import contextlib
    import io
    import tempfile

    from deepestscatter_tpu_torch import eval_e2e
    from deepestscatter_tpu_torch.train import device_data as dd
    from deepestscatter_tpu_torch.utils import compare, exr

    record = json.loads(EVAL_JSON.read_text())
    counters = {"K3": [ins_ops.sun_transmittance], "K7a": [collectors.generate_scatter_samples],
                "K7b": [collectors.radiance_moments], "K2": [desc_ops.network_inputs],
                "K10": [dd.assemble_disney, dd.assemble_baked], "K1": [march_ops.camera_march],
                "K5": [bnn.interpolate_probes]}
    tmp = tempfile.TemporaryDirectory()
    buf = io.StringIO()
    for fs in counters.values():
        for f in fs:
            f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rep = eval_e2e.run_r05(tmp.name, ground_truth=str(EVAL_REFERENCE), device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launched = {k: sum(f.launches for f in fs) for k, fs in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    warned = [ln for ln in buf.getvalue().splitlines() if TRAIN_WARNING in ln]
    rms = {}
    for name in ("nn", "nn_random", "bnn", "bnn_random"):
        rms[name] = dict(port=rep[f"rms_{name}"], eval_r05=record[f"rms_{name}"],
                         ratio=rep[f"rms_{name}"] / record[f"rms_{name}"])
    ratios = {k: rep[f"rms_{k}"] / rep[f"rms_{k}_random"] for k in ("nn", "bnn")}
    # The JAX package's own frames of EVAL_r05, committed beside the ground
    # truth: their means, and the port's trained frames against them.
    jax_frames = {k: exr.read_exr(str(EVAL_REFERENCE.parent / f"eval.{k.upper()}.exr"))
                  for k in ("nn", "bnn")}
    ours = Path(tmp.name) / "renders_{}x{}".format(*rep["resolution"])
    means = {k: dict(port=rep[f"mean_{k}"], jax=float(jax_frames[k].mean()))
             for k in ("nn", "bnn")}
    vs_jax = {k: compare.rms_bias(jax_frames[k], exr.read_exr(str(ours / f"eval.{k.upper()}.exr")))
              for k in ("nn", "bnn")}
    timings = {k: round(v, 3) for k, v in rep["timings"].items()}
    print(f"eval: scene={json.dumps(rep['held_out_scene'])} {rep['resolution']} "
          f"rms={json.dumps(rms)} frame_means={json.dumps(means)} "
          f"rms_against_jax_frames={json.dumps(vs_jax)} trained_over_random={json.dumps(ratios)} (tol "
          f"{EVAL_RANDOM_RATIO}; EVAL_r05 0.38, 0.44) bar(x{EVAL_BAR} EVAL_r05)="
          f"{json.dumps({k: EVAL_BAR * record[f'rms_{k}'] for k in ('nn', 'bnn')})} "
          f"val_loss_nn={rep['val_loss_nn']:.6f} val_loss_bnn={rep['val_loss_bnn']:.6f} "
          f"(EVAL_r05 {record['val_loss_bnn']:.4f}) steps_nn={rep['steps_nn']} "
          f"steps_bnn={rep['steps_bnn']} labels={rep['dataset']['train_labels']} "
          f"converged={rep['dataset']['train_labels_converged']} pt_mean={rep['pt_mean']:.6f} "
          f"timings_s={json.dumps(timings)} seconds={secs:.2f} peak_mem_mb={peak / 2**20:.1f} "
          f"launches={json.dumps(launched)} warning_lines={len(warned)} "
          f"device={json.dumps(rep['device'])}", flush=True)
    run_dir = Path(tmp.name) / "runs_seed566"
    eval_against_plain(collectors, desc_ops, ins_ops, pt, bnn, Path(tmp.name), run_dir, ours, dev)
    require(all(rep[f"finite_{k}"] for k in rms), "eval: a frame is not finite")
    require(bool(warned), "eval: the validation fallback's WARNING did not appear")
    require(all(launched[k] > 0 for k in EVAL_KERNELS),
            f"a kernel of the evaluation's path never launched: {launched}")
    for k in ("nn", "bnn"):
        require(ratios[k] <= EVAL_RANDOM_RATIO,
                f"eval: trained {k} RMS is {ratios[k]:.3f} of the untrained one's")
        require(rep[f"rms_{k}"] <= EVAL_BAR * record[f"rms_{k}"],
                f"eval: trained {k} RMS {rep[f'rms_{k}']:.5f} beyond {EVAL_BAR} x EVAL_r05's")
    return run_dir, tmp


def eval_against_plain(collectors, desc_ops, ins_ops, pt, bnn, root: Path, run_dir: Path,
                       img_dir: Path, dev) -> None:
    """The evaluation's kernels against their plain versions at its shapes
    and settings, after its run (not counted): K3 on both 64^3 scenes (train
    scene 0 and the held-out scene), bitwise; K7b on train scene 0's stored
    points with the evaluation's Russian roulette (``k7b_against_plain``,
    half the checked records from experiments past its first bounce); the
    held-out scene's trained NN and BNN frames, rendered again at the
    evaluation's seed, each equal bitwise to the EXR the evaluation scored
    and held against its all-plain frame (``against_plain``); the BNN's
    probe bake equal to the bake through K2's plain version, and K5 equal to
    its plain version on the frame's shading points."""
    from deepestscatter_tpu_torch import tasks
    from deepestscatter_tpu_torch.config import PointRadianceConfig
    from deepestscatter_tpu_torch.data import records
    from deepestscatter_tpu_torch.data.store import DatasetTriplet
    from deepestscatter_tpu_torch.render import camera as cam
    from deepestscatter_tpu_torch.utils import exr

    triplet = DatasetTriplet(str(root))
    base = tasks.eval_base()
    scenes = {}
    for label, store in (("train scene 0", triplet.train), ("held-out scene", triplet.validation)):
        cfg, params, static = tasks.scene_from_setup(store.table("SceneSetup").get_record(0), base,
                                                     device=dev)
        k3 = ins_ops.sun_transmittance(params, static)
        err3 = (k3 - ins_ops.sun_transmittance_plain(params, static)).abs().max().item()
        print(f"eval K3 bake, {label}: grid={static.grid_shape} max_abs_err={err3:.3g} (tol 0)",
              flush=True)
        require(err3 == 0.0, f"eval: K3 disagrees with its plain version on the {label}")
        scenes[label] = (cfg, params, static)

    _, params, static = scenes["train scene 0"]
    n = records.BATCH_SIZE
    samples = triplet.train.table("ScatterSample").read(0, n)
    pos = torch.as_tensor(samples["point"], device=dev)
    dirs = torch.as_tensor(samples["view_direction"], device=dev)
    rr = static.rr_start_depth
    kb = k7b_against_plain(collectors, pt, params, static, pos, dirs,
                           PointRadianceConfig(black_min_experiments=20_000), (0,),
                           torch.Generator().manual_seed(7), deep_from=rr)
    print(f"eval K7b, train scene 0 (Russian roulette from bounce {rr} at "
          f"{static.rr_survival}): points={n} replicas={kb['replicas']} "
          f"experiments={kb['lanes'] * kb['launches']} experiments_past_bounce_{rr}="
          f"{kb['deep_records']} checked={kb['checked'][0].shape[0]} "
          f"checked_past_bounce_{rr}={kb['deep_checked']} max_scatters_checked={kb['max_bounces']} "
          f"folds_equal_records={kb['fold_counts_ok']} fold_err(of tol)={kb['fold_err']:.3g} "
          f"steps_scatters_equal={kb['counts_eq']} max_abs_err={kb['err']:.3g} (tol 1e-5 of max) "
          f"plain_ms={kb['plain_ms']:.1f}", flush=True)
    require(kb["ok"], "eval: K7b disagrees with its plain version under Russian roulette")
    del pos, dirs, kb

    cfg, params, static = scenes["held-out scene"]
    basis = cam.camera_basis(cfg.camera)
    for kind in ("nn", "bnn"):
        weights = tasks.load_neural_weights(kind, str(run_dir), dev)
        renderer = tasks.build_neural_renderer(kind, weights, params, static, dev)
        frame = renderer.render_frame(params, static, WIDTH, HEIGHT, basis, seed=EVAL_RENDER_SEED)
        scored = np.array_equal(frame.cpu().numpy(),
                                exr.read_exr(str(img_dir / f"eval.{kind.upper()}.exr")))
        print(f"eval {kind.upper()} frame: equal_to_the_scored_exr={scored}", flush=True)
        require(scored, f"eval: the {kind} frame rendered again differs from the one scored")
        if kind == "nn":
            model = weights["DisneyModel"]

            def shade_plain(p, d):
                return model(desc_ops.network_inputs_plain(params, static, p, d))[:, 0]
        else:
            probes, renderer_model = renderer.probes, weights["ProbeRendererModel"]
            same_bake = torch.equal(probes, plain_descriptors(
                desc_ops, bnn.bake_probes, params, static, weights["LightProbeModel"],
                renderer.lattice))

            def shade_plain(p, d):
                probe_in = bnn.interpolate_probes_plain(params, static, probes, p, d)
                realtime = desc_ops.network_inputs_plain(params, static, p, d,
                                                         desc_ops.BAKED_REALTIME_LAYERS)
                return renderer_model(probe_in, realtime)[:, 0]
        k_cs, d = against_plain(f"eval {kind.upper()} frame vs plain", params, static, frame,
                                basis, shade_plain, seed=EVAL_RENDER_SEED)
        if kind == "bnn":
            pts = k_cs.scatter_pos[k_cs.has_scattered].contiguous()
            pdirs = d[k_cs.has_scattered].contiguous()
            k5 = bnn.interpolate_probes(params, static, probes, pts, pdirs)
            p5 = bnn.interpolate_probes_plain(params, static, probes, pts, pdirs)
            err5 = (k5 - p5).abs().max().item()
            print(f"eval BNN bake and K5: lattice={renderer.lattice} probes={tuple(probes.shape)} "
                  f"equal_to_plain_K2_bake={same_bake} K5_points={pts.shape[0]} "
                  f"K5_max_abs_err={err5:.3g} (tol 0, torch.equal)", flush=True)
            require(same_bake, "eval: the probe bake disagrees with the bake through K2's plain "
                               "version")
            require(torch.equal(k5, p5), "eval: K5 disagrees with its plain version")


def phase_cli(config, tasks, exr, models_dir: Path, out: Path, dev) -> None:
    """The command line in a subprocess from the repository root
    (``python -m deepestscatter_tpu_torch render``), the held-out cloud at
    the default settings: BNN from the eval phase's exports, then the path
    tracer capped at 4 subframes (one tick).  Gates: each EXR exists,
    is finite and 256 x 512 x 3; the BNN EXR equal, bitwise, to the same
    render through ``tasks.render_cloud`` in this process."""
    repo = Path(__file__).resolve().parent
    paths = {}
    for renderer, extra in (("bnn", ("--models-dir", str(models_dir))),
                            ("pt", ("--max-subframes", "4"))):
        cmd = [sys.executable, "-m", "deepestscatter_tpu_torch", "render", *CLI_ARGS,
               "--renderer", renderer, "--out", str(out / "cli"), *extra]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=600)
        secs = time.time() - t0
        path = out / "cli" / f"procedural_64_29.Side.{renderer.upper()}.exr"
        img = exr.read_exr(str(path)) if proc.returncode == 0 and path.exists() else None
        seen = "missing" if img is None else (f"shape={list(img.shape)} finite="
                                              f"{bool(np.isfinite(img).all())} mean={img.mean():.6f}")
        print(f"CLI {renderer}: rc={proc.returncode} seconds={secs:.2f} exr={path.name} {seen}",
              flush=True)
        require(img is not None, f"CLI {renderer} failed: {proc.stderr[-2000:]}")
        require(img.shape == (HEIGHT, WIDTH, 3) and bool(np.isfinite(img).all()),
                f"CLI {renderer}: the EXR is not finite or not {HEIGHT}x{WIDTH}x3")
        paths[renderer] = img
    (here,) = tasks.render_cloud(CLI_ARGS[0], str(out / "inproc"), "bnn", float(CLI_ARGS[2]),
                                 directions=(CLI_ARGS[4],), base=config.SceneConfig(),
                                 models_dir=str(models_dir), verbose=False, device=dev)
    same = np.array_equal(exr.read_exr(here), paths["bnn"])
    print(f"CLI bnn against tasks.render_cloud in this process: bitwise_equal={same}", flush=True)
    require(same, "CLI: the BNN render differs from the same render in this process")


def run() -> dict:
    """All phases; returns the kernel rows with their launch counts."""
    import deepestscatter_tpu_torch as port
    from deepestscatter_tpu_torch import config, cuda_build
    from deepestscatter_tpu_torch import scene as scene_mod
    from deepestscatter_tpu_torch.data import collectors, procedural
    from deepestscatter_tpu_torch.models.rpnn import init_disney_model
    from deepestscatter_tpu_torch.ops import descriptor as desc_ops
    from deepestscatter_tpu_torch.ops import grid as grid_ops
    from deepestscatter_tpu_torch.ops import march as march_ops
    from deepestscatter_tpu_torch.probes import gather
    from deepestscatter_tpu_torch.render import baked as bnn
    from deepestscatter_tpu_torch.render import camera as cam
    from deepestscatter_tpu_torch.render import inscatter as ins_ops
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
        march_ops, cuda_build, baked, static, entry, d[idx].contiguous(), idx)
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
    render = lambda seed: renderer.render_frame(params, static, WIDTH, HEIGHT, basis, seed=seed)  # noqa: E731
    warm = render(1)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    frames, times, peak = timed_frames(render)
    launches = {k: f.launches for k, f in counters.items()}
    n_rays, n_hit, n_scat = renderer.last_counts
    frame_ms = float(np.mean(times))
    print(f"frame: setup(build+bake+init+warm)={setup_s:.2f}s frames={len(times)} "
          f"ms_per_frame_mean={frame_ms:.3f} ms_min={min(times):.3f} "
          f"ms_all={[round(t, 3) for t in times]} frac_hit={n_hit / n_rays:.4f} "
          f"frac_scattered={n_scat / n_rays:.4f} peak_mem_mb={peak / 2**20:.1f} "
          f"launches={json.dumps(launches)} (per frame: K1 2, K2 {-(-n_scat // renderer.TILE)}; "
          f"K3 once per scene)", flush=True)
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    check_frames("frame", [warm] + frames, render(2), frames)

    # -- the frame against its all-plain counterpart -----------------------
    against_plain("frame vs plain", params, static, frames[0], basis,
                  lambda p, d: model(desc_ops.network_inputs_plain(params, static, p, d))[:, 0])
    phase_profile("profile", lambda: render(3), frame_ms)
    del model, renderer, frames, warm
    kernels = [dict(rows[k], launches=launches[k]) for k in ("K1", "K2", "K3")]

    # -- the baked (BNN) frame's main path, counted, on the same scene -------
    row, (pts, pdirs, probes) = phase_bnn(port, bnn, desc_ops, grid_ops, march_ops, params,
                                          static, basis, dev, frame_ms)
    kernels.append(row)
    phase_card_vs_cpu(desc_ops, bnn, collectors, scene_mod, params, static, pts, pdirs, probes)
    del params, pts, pdirs, probes

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
    probe_rows, gather_rows_per_s = phase_probe(gather, steps_per_s[256])
    kernels += [probe_rows["P1"], probe_rows["P2"]]

    # -- the dataset generator's main path, counted ---------------------------
    rows, tmp, collected = phase_collect(config, cuda_build, collectors, desc_ops, ins_ops, pt,
                                         dev, gather_rows_per_s)
    kernels += rows

    # -- training on the collected store, counted -----------------------------
    try:
        kernels += phase_train(port, tmp.name, collected, dev)
    finally:
        tmp.cleanup()
    del collected

    # -- the path tracer against the JAX package's ground truth, counted ------
    phase_ground_truth(prog, pt, ins_ops, dev)

    # -- the end-to-end quality check, counted; then the command line ---------
    from deepestscatter_tpu_torch import tasks
    from deepestscatter_tpu_torch.utils import exr

    models_dir, tmp = phase_eval(collectors, desc_ops, ins_ops, march_ops, pt, bnn, dev)
    try:
        phase_cli(config, tasks, exr, models_dir, Path(tmp.name), dev)
    finally:
        tmp.cleanup()
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
