#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``deepestscatter_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, one output line each:

1. ``env`` / ``build``: the card, torch and CUDA versions; the kernels
   built from ``deepestscatter_tpu_torch/csrc`` (one nvcc per source, in
   parallel, P1's designs and the first designs of K8a, K8b, K8c and K9
   included)
   with their ptxas register reports.
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
16. ``diff``: the differentiable single-scatter renderer
    (``render.diff``) driven the way a user drives it, counted (K3, K8a and
    K8b's four entries must launch): ``render_and_grads`` at its defaults
    point (``render_single_scatter``'s defaults, 64 x 32, 256 steps of
    1/256, density multiplier 100, on EVAL_r05's held-out cloud
    ``procedural:64:29`` normalised and unpadded, the sun, eye and light of
    tests/test_diff_cross_validation.py) in both in-scatter modes; the
    frame point's image and gradients of a float64 sum under fixed random
    weights (the RPNN frame's 256^3 cumulus of seed 11, 512 x 256, 896
    steps of 1/512, density multiplier 200, baked); ``sun_transmittance``
    and its gradient at the 64^3 cloud's voxel centres.  Gates: at the
    defaults point, both modes, the kernels against the plain versions on
    the card (image within 1e-5 of its largest value, the density gradient
    within 1e-4 of its largest, every other leaf within 1e-3), the bake's
    forward (K3, ``early_out=0``) bitwise equal to the plain bake there and
    at the frame point, the sun march within 1e-6 (T) and its gradients,
    K8a and K8b each against autograd of its plain version on the same
    inputs, and K8b's replay (the running prefix R - C) on the 64 rays with
    the most steps with sigma != 0 within 1e-4 of each ray's largest d/d
    entry and d/d dirs, at both points; the card against the plain version
    on the CPU on a 16^3 crop,
    both modes, at the same tolerances; at the frame point the image and
    gradients finite, the density, sun and eye gradients nonzero, the image
    bitwise equal over two runs and the gradients within 1e-5 (atomics),
    directional derivatives against central differences of the kernels'
    own forward (a random direction on the cloud's voxels, eps 1e-3,
    within 2 %; a random sun direction, within 5 % at any eps of 1e-3,
    3e-5, 1e-5); at the cross-validation point (16^3, 24 x 12, 400 m) the
    quadrature against K4's single-scatter mean of 600 subframes (mean
    within 5 %, median pixel error below 0.1).  It prints the forward and
    forward + backward times at both points, the plain version's time and
    peak memory at the defaults point, each kernel's time (CUDA events)
    beside its bound and its plain version's, each kernel beside its first
    design timed in turns in the same call (``csrc/diff_variants.cu``: a
    thread a voxel, ray or point; timed by
    ``probes/march_variants.py::against_first``,
    ``forward_against_first`` and ``sun_against_first``, the host
    enqueueing ahead behind a spin kernel that must outlast it) with the
    largest difference of each output from theirs (K8b's forward and the
    sun march's T bitwise), at both points and in both in-scatter modes;
    K8b's forward in each design (lanes a ray) at the defaults point, the
    sun march and its adjoint in each design (a thread or G lanes a point)
    at the 262,144 voxel centres; peak memory.  K8b's forward is held bitwise to the plain march at both
    points in both modes.  The kernels line's K8a and K8b rows are at the
    defaults point, baked, and K8b's again pointwise (its bound counting
    the sun march's samples at the lit steps, and for the adjoint at the
    dark steps too, those counted by the sun march kernel at their NEE
    points).
17. ``ms diff``: the differentiable multi-scatter renderer
    (``render.diff.multi_scatter_and_grads``) driven the way a user drives
    it, counted (K3, K4, K8c and K8a must launch): at the small point
    (tests/test_diff_cross_validation.py's gradient point: its 16^3 thin
    cloud at 400 m, step 1/64, all-scatter, 12 x 8, ``max_depth`` 3, 2
    subframes, seed 4) and at the frame point (the 256^3 cumulus of seed
    11 at 2000 m, step 1/512, the config's sun and eye, 512 x 256,
    ``max_depth`` 4, 2 subframes, seed 0: 262,144 paths).  Gates: the
    frame's image and gradients finite, the density, sun and eye gradients
    nonzero; at both points K8c's replayed records bitwise equal to K4's,
    K4's within 1e-5 of the plain paths', and K8c against autograd of the
    plain paths (``scatter_loop_plain`` on the card, float64 grid sums)
    for every input (density within 1e-5 of its largest value; in-scatter,
    light_dir, light_radiance, entries and directions within 1e-4): at the
    small point on every path for a random upstream, at the frame point
    on the 2,048 paths with the most steps under a random loss weighted to
    them; on the 64 of those with the most steps each path's d/d entry and
    d/d dirs within ``REPLAY_TOL`` = 1e-4 of its largest.  It prints
    forward and forward + backward ms at both points, K8c's device time
    (CUDA events with the host enqueueing ahead, ``ahead_ms``) beside its
    first design's (a thread a (sample, pixel), csrc/path_adjoint_variants.cu)
    in four turns, each also with a zero upstream (the replay alone; the
    difference is the sweep's share), the kernels' registers
    (``cudaFuncGetAttributes``), the work list's length and the sweep's
    lanes G at both points, the first design's records bitwise equal to
    the package's and its gradients within the tolerances above, and
    K8c's launches, its operation bound from the kernel's own
    replayed steps, in-box scatters and re-marched steps, the plain paths'
    time, K3, K4 and K8a at the frame point by CUDA events, the frame's
    forward + backward with the package's K8c and with its first design in
    four turns, the frame's device time by kernel and peak memory.  K8c's row: its time and bound
    at the frame point; its plain_ms the plain paths' forward + backward on
    the 2,048 deepest paths (the full frame's plain paths take minutes).

18. ``parallel``: multi-device rendering and training (``parallel``,
    ``train.trainer``'s data axis), counted (K3, K4, K9 and K10 must
    launch).  World 1 over NCCL in this process at the PT cell (the 256^3
    cumulus of seed 11, 2000 m, 512^2, all-scatter, ``max_depth`` 2000,
    uint8): ``ShardedProgressiveRenderer.tick()`` against
    ``ProgressiveRenderer.tick()``, bitwise at 1 subframe a tick and
    within tests/test_parallel.py:51-56's tolerances at 2 (the largest
    difference printed); ``make_spatial_subframe`` (K9, one slab) against
    ``render_subframe`` (K4) for the same seed, subframe and ids, bitwise
    on every pixel whose K4 sample stayed under its step cap (the pixels
    left out are counted; the two bounds differ there); K9 against
    ``spatial_phase_plain`` phase by phase on the 2,048 pixels with the
    most K4 steps (decisions equal, values within 1e-5 of each column's
    largest); the sharded bake (K3 over a plane range) against ``bake``,
    bitwise; a data-parallel training chunk (10 steps at batch 1,024
    through K10, seeded tables) equal to the undistributed chunk, bitwise.
    ``parallel K9 phase i``: a line a phase of the subframe (the rays alive
    at its start, the package's lanes a ray, the steps, the longest ray's,
    the steps a lane and warp iteration, a thread a ray's SIMT efficiency,
    the package's and the first design's ms) and ``parallel K9 against its
    first design``: K9 and its first design (csrc/spatial_variants.cu) on
    the subframe's replayed phases in four turns by ``ahead_ms``, the first
    design's records bitwise the package's at every phase, the registers.
    Times with the card's line (CUDA events): K9's ms for the subframe
    (its phases' launches replayed back to back on the recorded inputs)
    beside K4's, the phases, the merges' ms and the subframe's host ms, a
    2-subframe tick sharded and unsharded; the subframe's profile.  Then
    gloo worlds of 2 and 4 ranks sharing the card
    (``parallel.launch``) on the 64^3 cumulus at 128 x 64: the spatial
    subframe on 2 and 4 slabs and a 2 x 2 data x space mesh bitwise equal
    to world 1's, ``exchange_halos`` equal to ``HaloSlabGrid.scatter``,
    the sharded bake and the ticks at 1 and 2 subframes bitwise, and (world
    2) a training chunk within tests/test_torch_train_parity.py's
    tolerances of world 1's; each world prints its ranks' backend and
    device.  K9's row: its time for the subframe, its first design's in
    the same turns (``first_design_ms``), its plain version's ms on the
    2,048 pixels, its bound from the steps K9 marched and K4's in-box
    scatters of the same samples.

19. ``skip``: empty-space skipping on the main paths, counted (the
    skipping instantiations of K4, K7b, K7a and K1 must launch).  The PT
    cell at 256^3 and 64^3 with its occupancy built (a long step 16 and 64
    lattice steps): per static (no skip, the cell jump alone, the block
    skip alone) a ``ProgressiveRenderer`` of 17 ticks, its Mrays/s, K4's
    tick by CUDA events beside the default's, the steps sampled and
    jumped; each skip's K4 bitwise its plain version (steps, jumps and
    scatters equal, values within K4's tolerances) on the tick's samples of
    the 1,024 pixels with the most lattice steps (K4 a launch a subframe,
    the plain loop a lane a sample), and its image against the default image
    by ``render_agreement`` (independent seeds; a 1.02-scaled image must
    fail).  The collector's scene with its 2,048 samples: one radiance
    update (``estimate_point_radiance``) with the cell jump, K7b held to
    its plain version by ``k7b_against_plain`` (base 0), its time beside
    the default's; K7a with each skip bitwise its plain version (every
    field), the block skip by the profiler beside the default's, the cell
    jump against its first design (``csrc/march_variants.cu``: rounds of 8
    warps, a jump ending a chunk of 32 lanes) and the kernel without a skip
    in four turns by ``ahead_ms`` (``samples_against_first``).  These plain
    versions
    (K4's four, K7b's, K7a's two) run side by side in worker processes once
    the card's timings are taken (``run_plain_jobs``: each is bound by its
    host's launches).  The RPNN frame with the
    block skip (K1's two launches), K1's passes against
    ``camera_march_plain`` (``phase_k1``'s gates).  A row each (K4 cell
    jump and block skip, K7b cell jump, K7a cell jump and block skip, K1
    block skip): time beside the default's, launches, the bound from the
    steps sampled, the plain time on the checked work.  The cell jump of K4
    (at both sizes) and of K7b (the update's lanes) against its first
    design (``csrc/pathtrace_variants.cu``: a jump ends its lookahead
    chunk), beside the kernel without a skip, in four turns by
    ``ahead_ms`` (``jump_against_first``): times, warp march iterations,
    SIMT efficiency, steps sampled and jumped, the jumps and lattice steps
    a jump, registers and spills; the first design bitwise the package's
    (rows' ``first_design_ms``, ``ms_in_turns``).  K4's block skip at both
    sizes likewise against its first design (``csrc/pathtrace_variants.cu``:
    the float32 occupancy read at every step; ``block_against_first``):
    times, warp march iterations, SIMT efficiency, registers; the row's
    ``first_design_ms``, ``ms_in_turns``, iterations and registers at both
    sizes, and its bound at 64^3 (``bound_ms_64``).

Then the card's ``name, power.limit`` line, the ``{"kernels": [...]}``
line, and as the last line ``{"ok": true, "device": {...}}``.  A failed
check exits 1 before the last line; without a CUDA device the run exits 1
and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
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
#: The differentiable renderer (render/diff.py).  Defaults point:
#: render_single_scatter's own defaults on EVAL_r05's held-out cloud,
#: normalised and unpadded, with tests/test_diff_cross_validation.py's sun,
#: eye and light.
DIFF_CLOUD = (64, 29)
DIFF_SUN = (-0.3, -0.9, 0.1)
DIFF_EYE = (2.5, -0.4, 0.0)
DIFF_RADIANCE = 1e6
#: Frame point: the RPNN frame's scene (256^3 cumulus of seed 11, 2000 m /
#: 10 m), 512 x 256, step 1/512 and 896 steps (28 chunks of 32, past the
#: box diagonal's 887), baked in-scatter; the sun and eye of the config.
DIFF_FRAME_CLOUD = (256, 11)
DIFF_FRAME = dict(width=WIDTH, height=HEIGHT, density_multiplier=200.0, n_steps=896,
                  sample_step=1.0 / 512.0, remat_chunk=32, use_baked_inscatter=True)
#: Cross-validation point (tests/test_diff_cross_validation.py:38-110): a 16^3
#: random cloud at 400 m, 24 x 12, against K4's single-scatter mean.
XVAL_RES, XVAL_WIDTH, XVAL_HEIGHT, XVAL_SIZE_M, XVAL_TICKS = 16, 24, 12, 400.0, 60
#: Card against CPU: a 16^3 crop of the defaults cloud at a small frame.
DIFF_CPU = dict(width=32, height=16, density_multiplier=100.0, n_steps=224, sun_steps=64,
                sample_step=1.0 / 128.0, remat_chunk=32)
#: Tolerances against the plain version: image relative to its largest
#: value, the density gradient to its largest, the other leaves each.
DIFF_TOL = {"image": 1e-5, "density": 1e-4, "sun_dir": 1e-3, "eye": 1e-3, "look_at": 1e-3,
            "light_radiance": 1e-3}
#: Operations counted a step for the bounds: K8a a voxel-step (position,
#: coordinates, the cell and its 8 weights, 8 weighted atomic adds, the
#: slope from 8 taps, the light gradient).  K8b's forward a ray-step in the
#: box with sigma != 0 (a masked density sample ~90, a baked-grid sample
#: ~90, three exponentials, expm1, two divisions and the mean point, the
#: term) and with sigma == 0 (the masked density sample and tau: the term
#: is an exact 0).  Its backward a ray-step with sigma != 0 (the forward's
#: replay, two slopes and 16 weighted atomic adds, the chain) and with
#: sigma == 0 (the density sample, exp(-tau), the baked-grid sample at the
#: Taylor mean point for the segment weight's slope, the density texels' 8
#: weighted atomic adds and slope, the chain; no baked-grid scatter and no
#: mean-point slope: dS == 0 there).  The sun march a step in the box
#: (position, coordinates, the in-box test, a sample, tau) and its
#: adjoint's (its 8 weighted atomic adds and the slope in place of the sum).
K8A_OPS_PER_VOXEL_STEP = 100
K8B_OPS_PER_STEP = 220
K8B_DARK_OPS_PER_STEP = 95
K8B_BWD_OPS_PER_STEP = 480
K8B_BWD_DARK_OPS_PER_STEP = 290
K8B_SUN_OPS_PER_STEP = 100
K8B_SUN_BWD_OPS_PER_STEP = 150
#: Pointwise in-scatter: K8b's forward a lit step less the baked-grid
#: sample (~90), plus the sun march's samples it takes (K8B_SUN_OPS_PER_STEP
#: each); its backward a lit step less the baked-grid sample, slope and 8
#: weighted atomic adds (~150) and a dark step less the baked-grid sample,
#: plus the sun march's samples at every step in the box (the in-scatter
#: S, K8B_SUN_OPS_PER_STEP each) and its adjoint's at the lit steps
#: (K8B_SUN_BWD_OPS_PER_STEP each).
K8B_PW_OPS_PER_STEP = 130
K8B_PW_BWD_OPS_PER_STEP = 330
K8B_PW_BWD_DARK_OPS_PER_STEP = 200
#: The frame point's checks against the plain versions, on a part of its
#: work at its own shapes: K8b on the rays with the most steps with
#: sigma != 0 (the longest prefix sums), K8a with the upstream restricted
#: to a slab of z-slices.
FRAME_CHECK_RAYS = 2048
FRAME_CHECK_SLICES = 4
#: The R - prefix replay's error on the deepest rays, relative to each
#: ray's largest value: K8b's adjoint's tolerance for d/d entry and d/d dirs.
REPLAY_TOL = 1e-4
#: The differentiable multi-scatter renderer (render_multi_scatter_mc).
#: Small point: tests/test_diff_cross_validation.py:38-110,156-161 (its 16^3
#: thin cloud at 400 m, density multiplier 40, step 1/64, sun
#: DIFF_SUN, eye DIFF_EYE, light DIFF_RADIANCE, all-scatter), 12 x 8,
#: max_depth 3, 2 subframes, seed 4.  Frame point: DIFF_FRAME_CLOUD at
#: 2000 m (density multiplier 200, step 1/512: a step cap of 1,805 at
#: max_depth 4), SceneConfig()'s sun and eye, 512 x 256, max_depth 4, 2
#: subframes, seed 0: 262,144 paths.
MS_SMALL_RES, MS_SMALL_SIZE_M = 16, 400.0
MS_SMALL = dict(width=12, height=8, max_depth=3, n_subframes=2, seed=4)
MS_FRAME_SIZE_M = 2000.0
MS_FRAME = dict(width=WIDTH, height=HEIGHT, max_depth=4, n_subframes=2, seed=0)
#: K8c against the plain paths: the density gradient within 1e-5 of its
#: largest value, its other inputs within 1e-4 of theirs.
MS_TOL = {"density": 1e-5, "inscatter": 1e-4, "light_dir": 1e-4, "light_radiance": 1e-4,
          "entry": 1e-4, "dirs": 1e-4}
#: The frame point's check against the plain paths: the pixels whose two
#: samples take the most steps, under a loss weighted to them.
MS_CHECK_PATHS = 2048
#: K8c's operations: its replay is K4's work (K4_OPS_PER_STEP a step,
#: K4_OPS_PER_BOUNCE an in-box scatter, K4_OPS_PER_SAMPLE a sample); its
#: sweep re-marches the steps of every flight that ended in an in-box
#: scatter (the position twice, coordinates, the cell and its 8 weights,
#: the slope from 8 taps, 8 weighted adds to the run, the chain into the
#: start's adjoints) and takes each such scatter's adjoint (the phase lerp
#: and its slope, the in-scatter's taps, value, slope and 8 weighted adds,
#: the light's and direction's products, two hashes, the inverse CDF, sin
#: and cos, the frame and normalisation Jacobian, the pull-back's chain).
K8C_OPS_PER_REMARCH_STEP = 126
K8C_OPS_PER_ADJOINT_BOUNCE = 400


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
#: Profiles ``device_ms`` takes before it gives up on seeing a kernel: late
#: in a full run the profiler can see none of a window's launches.
PROFILE_TRIES = 3


def device_ms(fn, reps: int, kernel: str = "", cold: bool = False) -> float:
    """Mean device time a call of ``fn`` spends in kernels whose name holds
    ``kernel`` (every kernel for ""), from torch.profiler over ``reps``
    calls after a warm-up: for launches shorter than their host-side cost,
    which CUDA events would time instead.  ``cold``: each call after
    writing L2_FLUSH_BYTES (whose kernel is left out), so that its inputs
    come from HBM; back to back, a call whose bytes fit the L2 finds them
    there.  The profiler can miss launches (it saw 7 of 10 K7a launches in
    one run), so each kernel's time is the mean of the launches it saw,
    times its launches a call; a line says where launches went unseen.
    Where it saw none, the calls are profiled again, PROFILE_TRIES times
    in all."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof):
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]

    flush = torch.empty(L2_FLUSH_BYTES if cold else 0, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    skip = set()
    if cold:
        with profile(activities=[ProfilerActivity.CUDA]) as fprof:
            flush.zero_()
            torch.cuda.synchronize()
        skip = {e.key for e in kernels(fprof)}
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        evs = [e for e in kernels(prof) if kernel in e.key and e.key not in skip]
        if evs:
            break
        print(f"device_ms: the profiler saw no device time of {kernel or 'any kernel'} "
              f"(try {attempt} of {PROFILE_TRIES})", flush=True)
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
    return host_call(fn)[1]


def host_call(fn):
    """(``fn()``, its synchronized host milliseconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def kernel_row(name, source, replaces, err, ms, plain_ms, n_bytes, n_ops,
               library_ms=None) -> dict:
    """One entry of the kernels line; the bound is the larger of the bytes
    over the HBM rate and the operations over the float32 peak."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations", library_ms=library_ms)


#: Sources built beside the package's: P1's designs (probes.gather.variants),
#: the first designs of K8a and K8b's adjoint (csrc/diff_variants.cu), K8c's
#: (csrc/path_adjoint_variants.cu), K9's (csrc/spatial_variants.cu), the
#: cell jump's and K4's block skip's (csrc/pathtrace_variants.cu) and K7a's
#: cell jump's (csrc/march_variants.cu).
EXTRA_SOURCES = ("gather_variants", "diff_variants", "path_adjoint_variants", "spatial_variants",
                 "pathtrace_variants", "march_variants")


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


def phase_k1(march_ops, cuda_build, params, static, entry, dirs, ids, label="K1"):
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
        params, static, torch.zeros_like(k1.transmittance), entry, dirs,
        skip=march_ops.skip_mode(static, cell=False))
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
    print(f"{label} march: pass1_rays={n1} pass2_rays={n2} steps={s1}+{s2} T_max_abs_err={err:.3g} (tol 0) "
          f"ok_agree={agree:.6f} pos_within_1e-4={pos_ok:.6f} direct_within_1e-3max={direct_ok:.6f} "
          f"(tol 0.995) pass2_bitwise(ok,pos,direct)={bitwise:.6f} ms(pass1+pass2)={ms:.3f} "
          f"pass1_ms={ms1:.3f} pass2_ms={ms2:.3f} before_redesign_ms(PERF.md)={PREV_MS['K1']} "
          f"plain_ms={plain:.1f}", flush=True)
    print(f"{label} lanes: G={g} lane_step_slots={util[0][0]}+{util[1][0]} kernel_steps={util[0][1]}+{util[1][1]} "
          f"lane_utilisation(steps / slots)=pass1 {lanes[0]:.4f} pass2 {lanes[1]:.4f} "
          f"both {(util[0][1] + util[1][1]) / (util[0][0] + util[1][0]):.4f}", flush=True)
    require(err == 0.0 and min(agree, pos_ok, direct_ok) >= 0.995,
            f"{label} disagrees with its plain version")
    require((util[0][1], util[1][1]) == (s1, s2),
            f"{label}'s step counter disagrees with the plain steps")
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
    counts).  Tolerance: step, scatter and jumped-step counts equal on
    every pixel; mean within 1e-5 and m2 within 1e-4 of their largest
    values."""
    k = pt.scatter_loop(params, static, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = pt.scatter_loop_plain(params, static, *args)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    same = k.steps == r.steps
    share = same.float().mean().item()
    err = max((k.mean - r.mean).abs().max().item(), (k.m2 - r.m2).abs().max().item())
    ok = (torch.equal(k.count, r.count) and share == 1.0 and torch.equal(k.bounces, r.bounces)
          and torch.equal(k.jumped, r.jumped))
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
                      deep_from: int = 0, defer: bool = False) -> dict:
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
    checks and the checked lanes; with ``defer`` the plain runs' job
    (``"job"``, for ``run_plain_jobs``) in place of their checks, which
    ``k7b_plain_finish`` then makes."""
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
    out["checked"] = (po, pd, pids, psub)
    out["records"] = (prad, pwork)
    job = dict(fn=PLAIN_PT, args=(params, rs, po, pd, phit, pids, 0, psub, 1))
    if defer:
        out["job"] = job
        return out
    one, plain_ms = host_call(lambda: pt.scatter_loop_plain(*job["args"]))
    return k7b_plain_finish(out, one, plain_ms)


def k7b_plain_finish(out: dict, one, plain_ms: float) -> dict:
    """``k7b_against_plain``'s checks of its checked records against the
    plain runs' moments ``one`` (host ``plain_ms``)."""
    prad, pwork = out.pop("records")
    out["plain_ms"] = plain_ms
    out["err"] = (prad - one.mean).abs().max().item()
    out["counts_eq"] = (torch.equal(pwork[:, 0], one.steps)
                        and torch.equal(pwork[:, 1], one.bounces))
    out["longest_steps"] = int(one.steps.max())
    out["max_bounces"] = int(one.bounces.max())
    out["ok"] = (out["fold_counts_ok"] and out["fold_err"] <= 1.0 and out["counts_eq"]
                 and out["err"] <= 1e-5 * (one.mean.abs().max().item() + 1e-12))
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


# ---------------------------------------------------------------------------
# The differentiable renderer
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=2)
def diff_density(res: int, seed: int) -> np.ndarray:
    """The procedural cumulus, normalised and unpadded (made once a run:
    the ``diff`` and ``ms diff`` phases share the 256^3 one)."""
    from deepestscatter_tpu_torch.data import procedural
    from deepestscatter_tpu_torch.ops import grid as grid_ops

    return grid_ops.normalize_density(procedural.cumulus(resolution=res, seed=seed))


def diff_scene(diff, density, sun, eye, dev):
    return diff.diff_scene_from_numpy(
        density, np.asarray(sun, np.float32), np.asarray(eye, np.float32),
        np.zeros(3, np.float32), np.full(3, DIFF_RADIANCE, np.float32), device=dev)


def render_kw(diff, **kw) -> dict:
    """``render_single_scatter``'s arguments: its defaults, updated by kw."""
    import inspect

    params = inspect.signature(diff.render_single_scatter).parameters
    full = {k: p.default for k, p in params.items() if k not in ("scene", "device")}
    full.update(kw)
    return full


def diff_grads(diff, scene, kw, kernels=True, weights=None):
    """(image, gradients of the loss as a DiffScene) through the kernels
    (the public entry) or the plain versions; the loss is the image mean,
    or with ``weights`` the float64 sum of the image times them."""
    leaves = [t.detach().requires_grad_(True) for t in scene]
    s = diff.DiffScene(*leaves)
    if kernels:
        img = diff.render_single_scatter(s, device=scene.density.device, **kw)
    else:
        img = diff.render_single_scatter_plain(s, **kw)
    loss = img.mean() if weights is None else (img.to(torch.float64) * weights).sum()
    return img.detach(), diff.DiffScene(*torch.autograd.grad(loss, leaves))


def rel_errors(pairs) -> dict:
    """name -> (max abs err over the reference's largest value, max abs
    err, bitwise share) of each (name, got, reference)."""
    out = {}
    for name, a, b in pairs:
        a = a.detach().to(torch.float64).cpu()
        b = b.detach().to(torch.float64).cpu()
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        out[name] = (err / scale if scale > 0 else err, err,
                     (a == b).to(torch.float64).mean().item())
    return out


def check_errors(label: str, errs: dict, tol: dict) -> None:
    text = " ".join(f"{k}=(rel {v[0]:.3g} abs {v[1]:.3g} bitwise {v[2]:.4f} tol {tol[k]:g})"
                    for k, v in errs.items())
    print(f"{label}: {text}", flush=True)
    bad = [k for k, v in errs.items() if not v[0] <= tol[k]]
    require(not bad, f"{label}: {bad} past their tolerance")


def image_and_grad_errors(img, grads, ref_img, ref_grads) -> dict:
    return rel_errors([("image", img, ref_img)] + list(zip(ref_grads._fields, grads, ref_grads)))


def fd_check(label, loss, analytic: float, step, eps_list, rtol: float) -> None:
    """Central differences of ``loss`` along ``step(eps)`` against the
    analytic directional derivative; passes if any eps agrees (abs floor
    1e-7, as tests/test_diff_render.py)."""
    seen = []
    for eps in eps_list:
        fd = (loss(step(eps)) - loss(step(-eps))) / (2 * eps)
        seen.append((eps, fd))
        if abs(fd - analytic) <= max(rtol * abs(analytic), 1e-7):
            break
    ok = abs(seen[-1][1] - analytic) <= max(rtol * abs(analytic), 1e-7)
    print(f"{label}: analytic={analytic:.6g} central_differences={[(e, round(f, 6)) for e, f in seen]} "
          f"rel_err={abs(seen[-1][1] - analytic) / abs(analytic):.3g} (tol {rtol:g})", flush=True)
    require(ok, f"{label}: the gradient disagrees with central differences")


def diff_kernel_inputs(diff, scene, kw):
    """The main path's kernel inputs at ``kw``: the march's (through K3),
    the upstream of the image mean for each ray, the bake's T and the
    upstream of the baked grid (from K8b's backward)."""
    with torch.no_grad():
        m = diff.march_setup(scene, kernels=True, **kw)
        n = m.entry.shape[0]
        args = (scene.density, m.baked,
                None if m.to_sun is None else m.to_sun.contiguous(), m.entry.contiguous(),
                m.dirs.contiguous(), m.p_phase.contiguous(), m.hit.to(torch.uint8), m.meta)
        g_rad = torch.where(m.hit, scene.light_radiance.sum() / (3 * n),
                            torch.zeros((), device=m.hit.device)).to(torch.float32).contiguous()
        steps = torch.zeros((n, 3), dtype=torch.int32, device=m.hit.device)
        rad = diff.launch_march(*args, steps=steps)
        back = diff.launch_march_bwd(*args[:7], rad, g_rad, m.meta)
    return m, args, g_rad, steps, rad, back


def phase_diff(port, config, prog, ins_ops, dev) -> list:
    """The differentiable renderer: its main path counted (K3, K8a, K8b
    must launch), the gates of the module docstring, the timings; returns
    the kernel rows (at the defaults point, baked)."""
    from deepestscatter_tpu_torch.ops import grid as grid_ops
    from deepestscatter_tpu_torch.render import diff

    t_phase = time.time()
    laps = [t_phase]

    def lap(what: str) -> None:
        laps.append(time.time())
        print(f"diff: {what} took {laps[-1] - laps[-2]:.1f}s", flush=True)

    launchers = {"K3": ins_ops.sun_transmittance, "K8a": diff.launch_bake_adjoint,
                 "K8b": diff.launch_march, "K8b adjoint": diff.launch_march_bwd,
                 "K8b sun": diff.launch_sun_march, "K8b sun adjoint": diff.launch_sun_march_bwd}
    d64 = diff_density(*DIFF_CLOUD)
    scene64 = diff_scene(diff, d64, DIFF_SUN, DIFF_EYE, dev)
    base = config.SceneConfig()
    d256 = diff_density(*DIFF_FRAME_CLOUD)
    scene256 = diff_scene(diff, d256, base.light.direction, base.camera.eye, dev)
    kw_frame = render_kw(diff, **DIFF_FRAME)
    weights = torch.from_numpy(np.random.default_rng(7).random(
        (kw_frame["height"], kw_frame["width"], 3))).to(dev)
    centres = torch.from_numpy(np.stack(np.meshgrid(
        *(np.arange(n, dtype=np.float32) + 0.5 for n in d64.shape), indexing="ij")[::-1], -1)
        .reshape(-1, 3) / np.float32(max(d64.shape))).to(dev)
    sun_w = torch.from_numpy(
        np.random.default_rng(8).random(centres.shape[0]).astype(np.float32)).to(dev)
    sun_args = (100.0, 128, 1.0 / 256.0)

    # -- the main path, counted: the user's calls ------------------------------
    for f in launchers.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    main = {}
    for b in (True, False):
        before = {k: f.launches for k, f in launchers.items()}
        main[b] = diff.render_and_grads(scene64, device=dev, use_baked_inscatter=b)
    pointwise_launches = {k: f.launches - before[k] for k, f in launchers.items()}
    torch.cuda.reset_peak_memory_stats()
    frame = diff_grads(diff, scene256, kw_frame, weights=weights)
    torch.cuda.synchronize()
    frame_peak = torch.cuda.max_memory_allocated()
    sun_leaves = [scene64.density.detach().requires_grad_(True),
                  scene64.sun_dir.detach().requires_grad_(True), centres.clone().requires_grad_(True)]
    t_sun = diff.sun_transmittance(*sun_leaves, *sun_args, device=dev)
    sun_grads = torch.autograd.grad((t_sun * sun_w).sum(), sun_leaves)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in launchers.items()}
    print(f"diff: main path (render_and_grads at the defaults point, both in-scatter modes; "
          f"the frame point's image and gradients; sun_transmittance and its gradient at "
          f"{centres.shape[0]} voxel centres) {time.time() - t0:.2f}s launches={json.dumps(launches)} "
          f"(pointwise render_and_grads: {json.dumps(pointwise_launches)})", flush=True)
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the diff path never launched: {launches}")

    lap("set-up and the main path")

    # -- the defaults point: kernels against the plain versions on the card ---
    kw64 = render_kw(diff)
    for baked in (True, False):
        mode = "baked" if baked else "pointwise"
        kw = dict(kw64, use_baked_inscatter=baked)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ref = diff_grads(diff, scene64, kw, kernels=False)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        plain_peak = torch.cuda.max_memory_allocated()
        check_errors(f"diff defaults {mode}: kernels vs plain on the card",
                     image_and_grad_errors(*main[baked], *ref), DIFF_TOL)
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = time_ms(lambda: diff.render_single_scatter(scene64, device=dev, **kw), 5)
        both_ms = time_ms(lambda: diff.render_and_grads(scene64, device=dev, **kw), 5)
        peak = torch.cuda.max_memory_allocated()
        print(f"diff defaults {mode}: forward_ms={fwd_ms:.3f} forward+backward_ms={both_ms:.3f} "
              f"peak_mem_mb={peak / 2**20:.1f} plain_forward+backward_ms={plain_ms:.1f} "
              f"plain_peak_mem_mb={plain_peak / 2**20:.1f} card={card_line()!r}", flush=True)

    lap("the defaults point against the plain versions")

    # -- K3: the bake's forward bitwise equal to the plain bake ------------------
    for name, sc, dm, step in (("defaults", scene64, 100.0, 1.0 / 256.0),
                               ("frame", scene256, DIFF_FRAME["density_multiplier"],
                                DIFF_FRAME["sample_step"])):
        with torch.no_grad():
            sun_n = sc.sun_dir / torch.linalg.norm(sc.sun_dir)
            bbox = diff._bbox(sc.density)
            k = diff.bake_inscatter_diff(sc.density, bbox, sun_n, dm, step, device=dev)
            p = diff.bake_inscatter_diff_plain(sc.density, bbox, sun_n, dm, step)
        err = (k - p).abs().max().item()
        print(f"diff K3 bake forward ({name}): voxels={k.numel()} max_abs_err={err:.3g} (tol 0) "
              f"bitwise_share={(k == p).float().mean().item():.6f}", flush=True)
        require(err == 0.0, "K3's differentiable bake disagrees with its plain version")
        del k, p

    lap("K3 against the plain bake")

    # -- the sun march on its own against its plain version --------------------
    sp_leaves = [t.detach().requires_grad_(True) for t in sun_leaves]
    t_plain = diff.sun_transmittance_plain(*sp_leaves, *sun_args)
    sp_grads = torch.autograd.grad((t_plain * sun_w).sum(), sp_leaves)
    sun_tol = {"T": 1e-6, "density": 1e-4, "sun_dir": 1e-3, "pos": 1e-4}
    check_errors("diff sun_transmittance: kernels vs plain on the card", rel_errors(
        [("T", t_sun, t_plain)] + list(zip(("density", "sun_dir", "pos"), sun_grads, sp_grads))),
        sun_tol)
    del sp_grads, sp_leaves, t_plain

    lap("the sun march against its plain version")

    # -- the card against the CPU on a 16^3 crop --------------------------------
    c = d64.shape[0] // 2
    crop = np.ascontiguousarray(d64[c - 8:c + 8, c - 8:c + 8, c - 8:c + 8])
    for baked in (True, False):
        kw = render_kw(diff, **DIFF_CPU, use_baked_inscatter=baked)
        card = diff_grads(diff, diff_scene(diff, crop, DIFF_SUN, DIFF_EYE, dev), kw)
        cpu = diff_grads(diff, diff_scene(diff, crop, DIFF_SUN, DIFF_EYE, "cpu"), kw,
                         kernels=False)
        check_errors(f"diff card vs cpu ({'baked' if baked else 'pointwise'}, 16^3 crop)",
                     image_and_grad_errors(*card, *cpu), DIFF_TOL)

    lap("the card against the CPU")

    # -- the frame point ----------------------------------------------------------
    img, g = frame
    finite = bool(torch.isfinite(img).all()) and all(bool(torch.isfinite(t).all()) for t in g)
    nonzero = {k: float(getattr(g, k).abs().max()) for k in ("density", "sun_dir", "eye")}
    img2, g2 = diff_grads(diff, scene256, kw_frame, weights=weights)
    again = {k: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
             for k, a, b in zip(g._fields, g2, g)}
    fwd_ms = time_ms(lambda: diff.render_single_scatter(scene256, device=dev, **kw_frame), 3)
    both_ms = time_ms(lambda: diff_grads(diff, scene256, kw_frame, weights=weights), 3)
    print(f"diff frame: image_mean={img.mean().item():.6g} image_max={img.max().item():.6g} "
          f"finite={finite} grad_max={json.dumps(nonzero)} image_bitwise_again={torch.equal(img, img2)} "
          f"grad_max_rel_diff_again={json.dumps(again)} (tol 1e-5) forward_ms={fwd_ms:.2f} "
          f"forward+backward_ms={both_ms:.2f} peak_mem_mb={frame_peak / 2**20:.1f} "
          f"card={card_line()!r}", flush=True)
    require(finite, "diff frame: an image or gradient value is not finite")
    require(all(v > 0 for v in nonzero.values()), "diff frame: a gradient is zero")
    require(torch.equal(img, img2), "diff frame: the image differs run to run")
    require(all(v <= 1e-5 for v in again.values()), "diff frame: gradients differ run to run")
    del img2, g2

    def frame_loss(sc) -> float:
        with torch.no_grad():
            out = diff.render_single_scatter(sc, device=dev, **kw_frame)
            return float((out.to(torch.float64) * weights).sum())

    rng = np.random.default_rng(11)
    v = (torch.from_numpy(rng.uniform(-1.0, 1.0, d256.shape).astype(np.float32)).to(dev)
         * (scene256.density > 0))
    fd_check("diff frame d/d density (random direction on the cloud's voxels)", frame_loss,
             float((g.density.to(torch.float64) * v.to(torch.float64)).sum()),
             lambda e: scene256._replace(density=(scene256.density + e * v).contiguous()),
             [1e-3], 0.02)
    u = rng.normal(size=3)
    u = torch.from_numpy((u / np.linalg.norm(u)).astype(np.float32)).to(dev)
    fd_check("diff frame d/d sun_dir (random direction)", frame_loss,
             float((g.sun_dir.to(torch.float64) * u.to(torch.float64)).sum()),
             lambda e: scene256._replace(sun_dir=scene256.sun_dir + e * u),
             [1e-3, 3e-5, 1e-5], 0.05)
    del v, frame, g, img

    lap("the frame point's gates")

    # -- the cross-validation point: the quadrature against K4 -----------------
    raw = np.zeros((XVAL_RES,) * 3, np.float32)
    raw[3:-3, 3:-3, 3:-3] = np.random.default_rng(0).random((XVAL_RES - 6,) * 3).astype(np.float32)
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=XVAL_SIZE_M),
        light=config.DirectionalLight(direction=DIFF_SUN),
        camera=config.CameraConfig(width=XVAL_WIDTH, height=XVAL_HEIGHT),
        rendering=config.CloudRendering(sample_step=1.0 / 64.0, max_depth=4,
                                        mode=config.RenderMode.SUN_SINGLE_SCATTER),
    )
    params, static = port.build_scene(cfg, raw, device=dev)
    params = port.with_baked_inscatter(params, static, quantize=False, early_out=False, device=dev)
    r = prog.ProgressiveRenderer(cfg, params, static, seed=5, device=dev)
    for _ in range(XVAL_TICKS):
        r.tick()
    mc = r.hdr_image()
    xs = diff_scene(diff, grid_ops.normalize_density(raw), DIFF_SUN, cfg.camera.eye, dev)
    quad = diff.render_single_scatter(
        xs, width=XVAL_WIDTH, height=XVAL_HEIGHT, density_multiplier=static.density_multiplier,
        n_steps=128, sample_step=1.0 / 64.0, device=dev).cpu().numpy()
    hit = quad[..., 0] > 0.0
    mc_hit, quad_hit = mc[hit], quad[hit]
    mean_rel = abs(float(np.mean(quad_hit)) - float(np.mean(mc_hit))) / float(np.mean(mc_hit))
    med = float(np.median(np.abs(quad_hit - mc_hit) / (np.abs(mc_hit) + 0.05 * mc_hit.mean())))
    print(f"diff cross-validation against K4 ({r.state.subframe_id} subframes, single scatter): "
          f"hit_pixels={int(hit.sum())} quadrature_mean={np.mean(quad_hit):.6g} "
          f"k4_mean={np.mean(mc_hit):.6g} mean_rel_diff={mean_rel:.4f} (tol 0.05) "
          f"median_rel_pixel_err={med:.4f} (tol 0.1)", flush=True)
    require(hit.sum() > 50 and mean_rel <= 0.05 and med < 0.1,
            "diff: the quadrature disagrees with the path tracer")

    lap("the cross-validation point")

    # -- each kernel at both points: time, bound, the plain version ------------
    rows = diff_kernel_rows(diff, ins_ops, scene64, render_kw(diff), launches, sun_leaves,
                            sun_w, sun_args)
    lap("the kernel rows at the defaults point, baked, and the sun march")
    rows += diff_pointwise_rows(diff, scene64, render_kw(diff), pointwise_launches)
    lap("the kernel rows at the defaults point, pointwise")
    diff_frame_kernels(diff, ins_ops, scene256, kw_frame)
    lap("the kernels at the frame point")
    print(f"diff: phase {time.time() - t_phase:.1f}s", flush=True)
    return rows


def k8b_ops(steps: torch.Tensor, dark_sun: int = 0):
    """K8b's forward and adjoint operations for this run's steps [N, 3]
    (steps in the box, steps with sigma != 0, the sun march's samples at
    those: pointwise only); pointwise also ``dark_sun``, the sun march's
    samples at the steps with sigma == 0 (the adjoint's in-scatter there)."""
    n_in, n_lit, sun = (int(v) for v in steps.to(torch.int64).sum(dim=0).tolist())
    dark = n_in - n_lit
    if sun == 0:  # baked
        return (n_lit * K8B_OPS_PER_STEP + dark * K8B_DARK_OPS_PER_STEP,
                n_lit * K8B_BWD_OPS_PER_STEP + dark * K8B_BWD_DARK_OPS_PER_STEP)
    return (n_lit * K8B_PW_OPS_PER_STEP + dark * K8B_DARK_OPS_PER_STEP
            + sun * K8B_SUN_OPS_PER_STEP,
            n_lit * K8B_PW_BWD_OPS_PER_STEP + dark * K8B_PW_BWD_DARK_OPS_PER_STEP
            + (sun + dark_sun) * K8B_SUN_OPS_PER_STEP + sun * K8B_SUN_BWD_OPS_PER_STEP)


def k8b_against_plain(label, diff, m, args, rad, g_rad, rays, remat_chunk, back=None,
                      time_forward=True):
    """K8b's forward and adjoint against autograd of the plain march on
    ``rays`` (the kernel's adjoint given ``g_rad`` on those rays alone,
    unless ``back`` is given: the adjoint of every ray, when ``rays`` are
    all the rays with g != 0).  Every reference must be nonzero somewhere.
    Returns (forward errors, adjoint errors, the kernel's adjoint, the
    plain gradients, the plain forward's ms (None unless
    ``time_forward``: else the forward of the backward's run is compared),
    the plain forward + backward's ms)."""
    meta = m.meta
    if back is None:
        g_sub = torch.zeros_like(g_rad)
        g_sub[rays] = g_rad[rays]
        back = diff.launch_march_bwd(*args[:7], rad, g_sub, meta)
    baked = m.baked is not None
    insc = m.baked if baked else m.to_sun  # the in-scatter's leaf
    leaves = [args[0].detach().requires_grad_(True), insc.detach().requires_grad_(True)] + [
        t[rays].detach().requires_grad_(True) for t in args[3:6]]

    def plain_march(grad):
        with torch.set_grad_enabled(grad):
            return diff.quadrature_march_plain(
                leaves[0], leaves[1] if baked else None, None if baked else leaves[1], leaves[2],
                leaves[3], leaves[4], meta, remat_chunk)

    ref_rad, plain_f = host_call(lambda: plain_march(False)) if time_forward else (None, None)

    def plain_back():
        r = plain_march(True)
        return r.detach(), torch.autograd.grad(r, leaves, g_rad[rays])

    (ref_rad_b, ref_back), plain_b = host_call(plain_back)
    if ref_rad is None:
        ref_rad = ref_rad_b
    require(all(float(t.abs().max()) > 0 for t in (ref_rad, *ref_back)),
            f"{label}: a reference of the K8b check is zero on every checked ray")
    errs_f = rel_errors([("radiance", rad[rays], ref_rad)])
    check_errors(f"{label}: K8b forward against the plain march", errs_f, {"radiance": 1e-6})
    require(errs_f["radiance"][1] == 0.0,
            f"{label}: K8b's forward is not bitwise equal to the plain march")
    ins = "baked" if baked else "to_sun"
    errs_b = rel_errors(list(zip(
        ("density", ins, "entry", "dirs", "p_phase"),
        (back.density, getattr(back, ins), back.entry[rays], back.dirs[rays], back.p_phase[rays]),
        ref_back)))
    check_errors(f"{label}: K8b adjoint against autograd of the plain march", errs_b,
                 {"density": 1e-4, ins: 1e-4, "entry": 1e-4, "dirs": 1e-4, "p_phase": 1e-4})
    return errs_f, errs_b, back, ref_back, plain_f, plain_b


def deepest_replay(label, steps, back, ref_back, rays, n: int = 64) -> None:
    """The R - prefix replay on the ``n`` rays of ``rays`` with the most
    steps with sigma != 0 (the most terms in the prefix): each ray's d/d
    entry and d/d dirs against the plain version's (``ref_back``, indexed
    as ``rays``), relative to that ray's largest, within REPLAY_TOL."""
    order = torch.argsort(steps[rays, 1], descending=True)[:n]
    deep = rays[order]
    per_ray = max(
        float(((a[deep] - b[order]).abs().amax(dim=1)
               / b[order].abs().amax(dim=1).clamp_min(1e-30)).max())
        for a, b in ((back.entry, ref_back[2]), (back.dirs, ref_back[3])))
    print(f"{label}: K8b replay (R - prefix) on the {n} rays with the most steps with sigma != 0 "
          f"({int(steps[deep, 1].min())}-{int(steps[deep, 1].max())}; "
          f"{int(steps[deep, 0].min())}-{int(steps[deep, 0].max())} in the box): max per-ray "
          f"relative err of d/d entry and d/d dirs={per_ray:.3g} (tol {REPLAY_TOL:g})", flush=True)
    require(per_ray <= REPLAY_TOL, f"{label}: K8b's replay error {per_ray:.3g} on the deepest rays "
            f"is past {REPLAY_TOL:g}")


def diff_kernel_rows(diff, ins_ops, scene, kw, launches, sun_leaves, sun_w, sun_args) -> list:
    """K8a, K8b (forward, adjoint) and the sun march (forward, adjoint) at
    the defaults point, baked: each against its plain version on the same
    inputs, its time by CUDA events, the plain version's and the bound from
    the steps this data needs."""
    from deepestscatter_tpu_torch import cuda_build
    from deepestscatter_tpu_torch.probes import march_variants as mv

    m, args, g_rad, steps, rad, back = diff_kernel_inputs(
        diff, scene, dict(kw, use_baked_inscatter=True))
    meta = m.meta
    density = scene.density
    v = density.numel()
    n = m.entry.shape[0]
    n_in = int(steps[:, 0].sum().item())
    with torch.no_grad():
        sun_n = scene.sun_dir / torch.linalg.norm(scene.sun_dir)
    light = tuple(sun_n.tolist())
    # K3 takes the light as host floats: the bake's forward reads the
    # normalised sun direction back once a call.
    reads = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reads):
        sun_n.tolist()
    read_us = (time.perf_counter() - t0) / reads * 1e6
    trans = ins_ops.launch_bake(density, meta.bbox, light, meta.step, meta.density_multiplier,
                                False)
    bake_ms = time_ms(lambda: ins_ops.launch_bake(density, meta.bbox, light, meta.step,
                                                  meta.density_multiplier, False), 10)
    fwd_ms = time_ms(lambda: diff.render_single_scatter(scene, device=density.device, **kw), 10)
    print(f"diff K3 light read-back (defaults point): {read_us:.1f} us a call on an idle queue, "
          f"{read_us / 1e3 / fwd_ms:.4f} of the forward's {fwd_ms:.3f} ms (K3 {bake_ms:.4f} ms)",
          flush=True)
    gbar = back.baked.reshape(-1).contiguous()
    adj = diff.launch_bake_adjoint(density, meta.bbox, light, meta.density_multiplier, meta.step,
                                   trans, gbar)
    # K8a against autograd of the plain bake on the same upstream.
    dl = density.detach().requires_grad_(True)
    ll = sun_n.detach().requires_grad_(True)
    bbox_t = diff._bbox(density)

    def plain_adjoint():
        out = diff.bake_inscatter_diff_plain(dl, bbox_t, ll, meta.density_multiplier, meta.step)
        return torch.autograd.grad(out, (dl, ll), gbar.reshape(density.shape))

    ref_adj, plain_a = host_call(plain_adjoint)
    errs_a = rel_errors([("density", adj[0], ref_adj[0]), ("light_dir", adj[1], ref_adj[1])])
    check_errors("diff K8a against autograd of the plain bake", errs_a,
                 {"density": 1e-4, "light_dir": 1e-3})
    voxels_g = int((gbar != 0).sum().item())
    steps_a = voxels_g * ins_ops.bake_steps(meta.step, False)

    # K8b forward and adjoint against the plain march on the same inputs
    # (every ray with an upstream gradient: those that hit the box).
    hit_rays = torch.nonzero(m.hit).squeeze(1)
    errs_f, errs_b, _, ref_back, plain_f, plain_b = k8b_against_plain(
        "diff defaults", diff, m, args, rad, g_rad, hit_rays, kw["remat_chunk"], back=back)
    deepest_replay("diff defaults", steps, back, ref_back, hit_rays)
    fwd = forward_against_first("diff defaults baked", mv, args, 20)
    ms_f = fwd["ms"]
    first = mv.against_first((density, meta.bbox, light, meta.density_multiplier, meta.step,
                              trans, gbar), (*args[:7], rad, g_rad, meta), 5, 20)
    ms_a, ms_b = first["ms_a"], first["ms_b"]
    forward_sweep("diff defaults baked", mv, args, 20)

    # The sun march on its own, at the main path's voxel centres.
    dens_s, sun_s, pos_s = (t.detach() for t in sun_leaves)
    to_sun = diff._to_sun(sun_s).contiguous()
    dm_s, n_s, step_s = sun_args
    sun_steps = torch.zeros(pos_s.shape[0], dtype=torch.int32, device=pos_s.device)
    t_k = diff.launch_sun_march(dens_s, to_sun, pos_s, dm_s, n_s, step_s, steps=sun_steps)
    steps_s = int(sun_steps.to(torch.int64).sum())
    sun_fwd = (dens_s, to_sun, pos_s, dm_s, n_s, step_s)
    sun_bwd = (dens_s, to_sun, pos_s, t_k, sun_w, dm_s, n_s, step_s)
    sun_first = sun_against_first(f"diff sun march ({pos_s.shape[0]} voxel centres)", mv,
                                  sun_fwd, sun_bwd, 10)
    ms_s, ms_sb = sun_first["ms"], sun_first["ms_bwd"]
    lib = cuda_build.load("diff_variants")
    for key, r in mv.sun_sweep(lib, sun_fwd, sun_bwd, 10).items():
        print(f"diff sun march designs ({pos_s.shape[0]} voxel centres; {card_line()}) {key}: "
              f"{json.dumps(r)}", flush=True)
        require(r.get("bitwise", True) and r.get("equal", True),
                f"diff sun march design {key} disagrees with the package's")
    with torch.no_grad():
        t_p, plain_s = host_call(lambda: diff.sun_transmittance_plain(dens_s, sun_s, pos_s,
                                                                       *sun_args))

    def plain_sun_back():
        ls = [t.detach().requires_grad_(True) for t in (dens_s, sun_s, pos_s)]
        return torch.autograd.grad(
            (diff.sun_transmittance_plain(*ls, *sun_args) * sun_w).sum(), ls)

    ref_sun, plain_sb = host_call(plain_sun_back)
    err_s = (t_k - t_p).abs().max().item()
    k_sun_grads = diff.launch_sun_march_bwd(dens_s, to_sun, pos_s, t_k, sun_w, dm_s, n_s, step_s)
    err_sb = (k_sun_grads[0] - ref_sun[0]).abs().max().item()

    grid_b = v * 4
    ops_f, ops_b = k8b_ops(steps)
    print(f"diff kernels (defaults point, baked; {card_line()}): K8a ms={ms_a:.4f} "
          f"(first design {first['ms_a_first']:.4f} in turns) "
          f"voxels_with_gradient={voxels_g} of {v} voxel_steps={steps_a} plain_ms={plain_a:.1f}; "
          f"K8b rays={n} steps_in_box={n_in} steps_with_sigma={int(steps[:, 1].sum())} "
          f"forward_ms={ms_f:.4f} (first design {fwd['ms_first']:.4f} in turns; "
          f"{fwd['lanes']} lanes a ray) plain_ms={plain_f:.1f} "
          f"adjoint_ms={ms_b:.4f} (first design {first['ms_b_first']:.4f} in turns) "
          f"plain_forward+backward_ms={plain_b:.1f}; against the first designs "
          f"{json.dumps({k: float(f'{e:.3g}') for k, e in first['rel_err'].items()})}; sun march "
          f"points={pos_s.shape[0]} steps={steps_s} ms={ms_s:.4f} (first design "
          f"{sun_first['ms_first']:.4f}) plain_ms={plain_s:.1f} adjoint_ms={ms_sb:.4f} (first "
          f"design {sun_first['ms_bwd_first']:.4f}) plain_forward+backward_ms={plain_sb:.1f}",
          flush=True)
    ray_in = n * (12 + 12 + 4 + 1 + 4)
    rows = [
        dict(kernel_row("K8a adjoint bake", "deepestscatter_tpu_torch/csrc/diff.cu",
                        "deepestscatter_tpu/render/diff.py:299", errs_a["density"][1], ms_a,
                        plain_a, 4 * grid_b, steps_a * K8A_OPS_PER_VOXEL_STEP),
             launches=launches["K8a"]),
        dict(kernel_row("K8b quadrature march", "deepestscatter_tpu_torch/csrc/diff.cu",
                        "deepestscatter_tpu/render/diff.py:198", errs_f["radiance"][1], ms_f,
                        plain_f, 2 * grid_b + ray_in, ops_f),
             launches=launches["K8b"]),
        dict(kernel_row("K8b quadrature march adjoint", "deepestscatter_tpu_torch/csrc/diff.cu",
                        "deepestscatter_tpu/render/diff.py:198", errs_b["density"][1], ms_b,
                        plain_b, 4 * grid_b + ray_in + n * 32, ops_b),
             launches=launches["K8b adjoint"]),
        dict(kernel_row("K8b sun march", "deepestscatter_tpu_torch/csrc/diff.cu",
                        "deepestscatter_tpu/render/diff.py:64", err_s, ms_s, plain_s,
                        grid_b + pos_s.shape[0] * 16, steps_s * K8B_SUN_OPS_PER_STEP),
             launches=launches["K8b sun"]),
        dict(kernel_row("K8b sun march adjoint", "deepestscatter_tpu_torch/csrc/diff.cu",
                        "deepestscatter_tpu/render/diff.py:64", err_sb, ms_sb, plain_sb,
                        2 * grid_b + pos_s.shape[0] * 44, steps_s * K8B_SUN_BWD_OPS_PER_STEP),
             launches=launches["K8b sun adjoint"]),
    ]
    return rows


def forward_against_first(label, mv, args, reps) -> dict:
    """K8b's forward against its first design (a thread a ray) in turns:
    the radiance and the step counts bitwise equal."""
    r = mv.forward_against_first(args, reps)
    print(f"{label}: K8b forward ms={r['ms']:.4f} first design (a thread a ray) "
          f"ms={r['ms_first']:.4f} in turns, {r['lanes']} lanes a ray, rays={args[3].shape[0]}, "
          f"bitwise (radiance, step counts)={r['bitwise']} ({card_line()})", flush=True)
    require(r["bitwise"], f"{label}: K8b's forward differs from its first design")
    return r


def forward_sweep(label, mv, args, reps) -> None:
    """K8b's forward in each design of march_variants.FORWARD_DESIGNS, each
    bitwise against the package's kernel."""
    from deepestscatter_tpu_torch import cuda_build

    lib = cuda_build.load("diff_variants")
    mv.diff_lib(lib)
    for key, r in mv.forward_sweep(lib, args, reps).items():
        print(f"{label} designs ({args[3].shape[0]} rays; {card_line()}) {key}: {json.dumps(r)}",
              flush=True)
        require(r["bitwise"], f"{label}: K8b forward design {key} differs from the package's")


def sun_against_first(label, mv, fwd, bwd, reps) -> dict:
    """The sun march and its adjoint against their first designs (a thread
    a point) in turns: T and the samples bitwise, the adjoint within 1e-5
    of each output's largest."""
    r = mv.sun_against_first(fwd, bwd, reps)
    print(f"{label}: sun march ms={r['ms']:.4f} (a thread a point) first design "
          f"ms={r['ms_first']:.4f}; adjoint ms={r['ms_bwd']:.4f} (a thread a point, runs merged) "
          f"first design ms={r['ms_bwd_first']:.4f}; in turns; T and samples bitwise="
          f"{r['bitwise']} adjoint against the first design "
          f"{json.dumps({k: float(f'{e:.3g}') for k, e in r['rel_err'].items()})} (tol 1e-5) "
          f"({card_line()})", flush=True)
    require(r["bitwise"] and all(e <= 1e-5 for e in r["rel_err"].values()),
            f"{label}: the sun march differs from its first design")
    return r


def dark_step_sun_samples(diff, args, meta) -> tuple:
    """(the sun march's samples in the box at the NEE points of the steps in
    the box with sigma == 0, those steps): K8b's adjoint reads the
    in-scatter there (the segment weight's slope), its forward does not.
    The points from step_sample's expressions (at sigma == 0 its Taylor
    mean point), counted by the sun march kernel."""
    density, _, to_sun, entry, dirs = args[:5]
    hit = args[6].bool()
    e, d = entry[hit], dirs[hit]
    step = meta.step
    s = torch.tensor([diff._step_distance(step, i + 1) for i in range(meta.n_steps)],
                     dtype=torch.float32, device=e.device)
    bbox = diff._bbox(density)
    p = e[:, None, :] + d[:, None, :] * s[:, None]
    u = p / bbox
    inside = ((u >= 0.0) & (u <= 1.0)).all(dim=-1)
    sigma = diff.sample_density(density, bbox, p.reshape(-1, 3)).reshape(inside.shape)
    dark = inside & (sigma * meta.density_multiplier == 0.0)
    a = torch.tensor(1e-6 * step, dtype=torch.float32)
    back = step - step * (0.5 - a / 12.0)
    q = (p - d[:, None, :] * back.to(e.device))[dark].contiguous()
    counts = torch.zeros(q.shape[0], dtype=torch.int32, device=e.device)
    diff.launch_sun_march(density, to_sun, q, meta.density_multiplier, meta.sun_steps, step,
                          steps=counts)
    return int(counts.to(torch.int64).sum()), int(dark.sum())


def diff_pointwise_rows(diff, scene, kw, launches) -> list:
    """K8b's forward and adjoint at the defaults point in pointwise mode:
    against the plain march (the forward bitwise) and its replay, each
    against its first design in turns, the G sweep of the forward, the
    bound from the steps and the sun march's samples this data needs; the
    kernel rows with the pointwise render's launches."""
    from deepestscatter_tpu_torch.probes import march_variants as mv

    m, args, g_rad, steps, rad, back = diff_kernel_inputs(
        diff, scene, dict(kw, use_baked_inscatter=False))
    meta = m.meta
    n = m.entry.shape[0]
    hit_rays = torch.nonzero(m.hit).squeeze(1)
    label = "diff defaults pointwise"
    errs_f, errs_b, _, ref_back, plain_f, plain_b = k8b_against_plain(
        label, diff, m, args, rad, g_rad, hit_rays, kw["remat_chunk"], back=back)
    deepest_replay(label, steps, back, ref_back, hit_rays)
    fwd = forward_against_first(label, mv, args, 10)
    adj = mv.against_first(None, (*args[:7], rad, g_rad, meta), 0, 10)
    print(f"{label}: K8b adjoint ms={adj['ms_b']:.4f} first design (a thread a ray) "
          f"ms={adj['ms_b_first']:.4f} in turns, {adj['lanes']} lanes a ray; against it "
          f"{json.dumps({k: float(f'{e:.3g}') for k, e in adj['rel_err'].items()})} (tol 1e-5)",
          flush=True)
    require(all(e <= 1e-5 for e in adj["rel_err"].values()),
            f"{label}: K8b's adjoint differs from its first design")
    forward_sweep(label, mv, args, 10)
    dark_sun, dark = dark_step_sun_samples(diff, args, meta)
    n_in, n_lit, sun = (int(v) for v in steps.to(torch.int64).sum(dim=0).tolist())
    ops_f, ops_b = k8b_ops(steps, dark_sun)
    print(f"{label}: K8b rays={n} steps_in_box={n_in} steps_with_sigma={n_lit} "
          f"sun_samples_at_those={sun} steps_with_sigma_0={n_in - n_lit} (by PyTorch's sample "
          f"{dark}) sun_samples_at_those={dark_sun} forward_ops={ops_f} adjoint_ops={ops_b} "
          f"forward_bound_ms={ops_f / F32_OPS_PER_S * 1e3:.4f} "
          f"adjoint_bound_ms={ops_b / F32_OPS_PER_S * 1e3:.4f} plain_ms={plain_f:.1f} "
          f"plain_forward+backward_ms={plain_b:.1f}", flush=True)
    grid_b = scene.density.numel() * 4
    ray_in = n * (12 + 12 + 4 + 1 + 4)
    return [
        dict(kernel_row("K8b quadrature march (pointwise)", "deepestscatter_tpu_torch/csrc/diff.cu",
                        "deepestscatter_tpu/render/diff.py:198", errs_f["radiance"][1], fwd["ms"],
                        plain_f, grid_b + ray_in + 12, ops_f),
             launches=launches["K8b"]),
        dict(kernel_row("K8b quadrature march adjoint (pointwise)",
                        "deepestscatter_tpu_torch/csrc/diff.cu",
                        "deepestscatter_tpu/render/diff.py:198", errs_b["density"][1], adj["ms_b"],
                        plain_b, 2 * grid_b + ray_in + n * 32 + 12, ops_b),
             launches=launches["K8b adjoint"]),
    ]


def diff_frame_kernels(diff, ins_ops, scene, kw) -> None:
    """K3, K8a and K8b at the frame point: times by CUDA events beside
    their bounds, and K8a and K8b against their plain versions on a part of
    the frame's work at its own shapes (the plain bake of every voxel would
    keep ~60 GB for its backward): K8b's forward and adjoint on the
    FRAME_CHECK_RAYS rays with the most steps in the box (the R - prefix
    over the frame's depth, the float32 atomics of the density and
    baked-grid scatters), K8a with the upstream restricted to the
    FRAME_CHECK_SLICES z-slices where it is most often nonzero (each
    march's clamped samples on the box's faces, the float32 slope of the
    light gradient)."""
    from deepestscatter_tpu_torch.probes import march_variants as mv

    m, args, g_rad, steps, rad, back = diff_kernel_inputs(diff, scene, kw)
    meta = m.meta
    density = scene.density
    v = density.numel()
    with torch.no_grad():
        sun_n = scene.sun_dir / torch.linalg.norm(scene.sun_dir)
    light = tuple(sun_n.tolist())
    n_bake = ins_ops.bake_steps(meta.step, False)
    bake = lambda: ins_ops.launch_bake(density, meta.bbox, light, meta.step,  # noqa: E731
                                       meta.density_multiplier, False)
    trans = bake()
    gbar = back.baked.reshape(-1).contiguous()
    ms3 = time_ms(bake, 3)
    first = mv.against_first((density, meta.bbox, light, meta.density_multiplier, meta.step,
                              trans, gbar), (*args[:7], rad, g_rad, meta), 3, 5)
    ms_a, ms_b = first["ms_a"], first["ms_b"]
    fwd = forward_against_first("diff frame", mv, args, 5)
    ms_f = fwd["ms"]
    n_in, n_lit = (int(x) for x in steps[:, :2].to(torch.int64).sum(dim=0).tolist())
    ops_f, ops_b = k8b_ops(steps)
    voxels_g = int((gbar != 0).sum().item())
    b3 = v * n_bake * K3_OPS_PER_VOXEL_STEP / F32_OPS_PER_S * 1e3
    ba = voxels_g * n_bake * K8A_OPS_PER_VOXEL_STEP / F32_OPS_PER_S * 1e3
    bf = ops_f / F32_OPS_PER_S * 1e3
    bb = ops_b / F32_OPS_PER_S * 1e3
    print(f"diff kernels (frame point; {card_line()}): K3 forward ms={ms3:.3f} "
          f"(voxels={v} steps={n_bake} bound_ms={b3:.3f}); K8a ms={ms_a:.3f} "
          f"(first design {first['ms_a_first']:.3f} in turns; "
          f"voxels_with_gradient={voxels_g} bound_ms={ba:.3f}); K8b rays={m.entry.shape[0]} "
          f"hit={int(m.hit.sum())} steps_in_box={n_in} steps_with_sigma={n_lit} "
          f"forward_ms={ms_f:.3f} (first design {fwd['ms_first']:.3f} in turns; "
          f"bound_ms={bf:.4f}) adjoint_ms={ms_b:.3f} "
          f"(first design {first['ms_b_first']:.3f} in turns; bound_ms={bb:.4f}); against the first "
          f"designs {json.dumps({k: float(f'{e:.3g}') for k, e in first['rel_err'].items()})}",
          flush=True)

    # K8b on the rays with the most steps with sigma != 0, against the plain
    # march at the frame's depth.
    rays = torch.argsort(steps[:, 1], descending=True)[:FRAME_CHECK_RAYS]
    label = (f"diff frame ({FRAME_CHECK_RAYS} rays, {int(steps[rays, 1].min())}-"
             f"{int(steps[rays, 1].max())} steps with sigma != 0, {int(steps[rays, 0].min())}-"
             f"{int(steps[rays, 0].max())} in the box, of {meta.n_steps})")
    _, _, back_k, ref_back, _, plain_b = k8b_against_plain(
        label, diff, m, args, rad, g_rad, rays, kw["remat_chunk"], time_forward=False)
    deepest_replay("diff frame", steps, back_k, ref_back, rays)
    print(f"{label}: plain_forward+backward_ms={plain_b:.1f}", flush=True)
    del back_k, ref_back

    # K8a on a slab of z-slices, against autograd of the plain bake of it.
    nz, ny, nx = density.shape
    per_slice = (gbar.reshape(density.shape) != 0).sum(dim=(1, 2))
    z0 = int(per_slice.unfold(0, FRAME_CHECK_SLICES, 1).sum(dim=1).argmax())
    block = torch.arange(z0 * ny * nx, (z0 + FRAME_CHECK_SLICES) * ny * nx,
                         device=density.device)
    g_block = torch.zeros_like(gbar)
    g_block[block] = gbar[block]
    adj = diff.launch_bake_adjoint(density, meta.bbox, light, meta.density_multiplier, meta.step,
                                   trans, g_block)
    dl = density.detach().requires_grad_(True)
    ll = sun_n.detach().requires_grad_(True)

    def plain_adjoint():
        out = diff.bake_inscatter_diff_plain(dl, diff._bbox(density), ll,
                                             meta.density_multiplier, meta.step, voxels=block)
        return out.detach(), torch.autograd.grad(out, (dl, ll), gbar[block])

    (t_plain, ref_adj), plain_a = host_call(plain_adjoint)
    require(all(float(t.abs().max()) > 0 for t in ref_adj),
            "diff frame K8a: a reference gradient of the slab is zero")
    face = torch.zeros(density.shape, dtype=torch.bool, device=density.device)
    for axis in range(3):
        face.index_fill_(axis, torch.tensor([0, density.shape[axis] - 1],
                                            device=density.device), True)
    face_err = float((adj[0] - ref_adj[0])[face].abs().max() / ref_adj[0].abs().max())
    print(f"diff frame K8a block: z={z0}-{z0 + FRAME_CHECK_SLICES - 1} voxels={block.numel()} "
          f"with_gradient={int((gbar[block] != 0).sum())} forward_bitwise="
          f"{torch.equal(t_plain, trans[block])} face_texels_with_gradient="
          f"{int((ref_adj[0][face] != 0).sum())} face_err_over_max={face_err:.3g} "
          f"plain_forward+backward_ms={plain_a:.1f}", flush=True)
    check_errors("diff frame K8a (the slab's upstream) against autograd of the plain bake",
                 rel_errors([("density", adj[0], ref_adj[0]), ("light_dir", adj[1], ref_adj[1])]),
                 {"density": 1e-4, "light_dir": 1e-3})


# ---------------------------------------------------------------------------
# The differentiable multi-scatter renderer
# ---------------------------------------------------------------------------


def ms_points(config, diff, dev):
    """(scene, config) at the small point and at the frame point."""
    from deepestscatter_tpu_torch.ops import grid as grid_ops

    raw = np.zeros((MS_SMALL_RES,) * 3, np.float32)
    raw[3:-3, 3:-3, 3:-3] = np.random.default_rng(0).random(
        (MS_SMALL_RES - 6,) * 3).astype(np.float32)
    small = diff_scene(diff, grid_ops.normalize_density(raw), DIFF_SUN, DIFF_EYE, dev)
    cfg_small = config.SceneConfig(
        cloud=config.CloudModel(size_m=MS_SMALL_SIZE_M),
        light=config.DirectionalLight(direction=DIFF_SUN),
        rendering=config.CloudRendering(sample_step=1.0 / 64.0))
    base = config.SceneConfig()
    frame = diff_scene(diff, diff_density(*DIFF_FRAME_CLOUD), base.light.direction,
                       base.camera.eye, dev)
    cfg_frame = config.SceneConfig(cloud=config.CloudModel(size_m=MS_FRAME_SIZE_M))
    return (small, cfg_small), (frame, cfg_frame)


def ms_paths(diff, scene, cfg, kw):
    """The paths' inputs at ``kw`` (K3 bakes the in-scatter): params,
    static, rays and K8c's differentiable inputs (density, in-scatter,
    light_dir, light_radiance, entry, dirs), detached."""
    with torch.no_grad():
        params, static = diff.diff_scene(cfg, scene, kw["max_depth"])
        rays = diff.path_rays(scene, cfg, kw["width"], kw["height"], params, static)
    inputs = [t.detach().contiguous() for t in (
        params.density_mips[0], params.inscatter, params.light_dir, params.light_radiance,
        rays.entry, rays.dirs)]
    return params, static, rays, inputs


def ms_args(diff, params, static, rays, inputs, kw) -> tuple:
    """``launch_path_adjoint``'s arguments but the upstream."""
    p = diff._sample_params(inputs[0], inputs[1], params.phase)
    return (p, static, inputs[4], inputs[5], rays.hit, rays.ids, kw["seed"], 1,
            kw["n_subframes"])


def ms_k8c(diff, params, static, rays, inputs, kw, g, remarch=None):
    return diff.launch_path_adjoint(*ms_args(diff, params, static, rays, inputs, kw), g,
                                    remarch=remarch)


def k8c_against_first(label, mv, diff, params, static, rays, inputs, kw, g, reps) -> dict:
    """K8c's two kernels against its first design (csrc/path_adjoint_variants.cu)
    in turns, each also with a zero upstream (the replay alone): printed
    with the sweep's share, the kernels' registers, the work list's length
    and the sweep's lanes; the first design's records bitwise equal to the
    package's and its gradients within the plain paths' tolerances."""
    r = mv.path_against_first(ms_args(diff, params, static, rays, inputs, kw), g, reps)
    print(f"{label} K8c against its first design ({card_line()}): ahead_ms={r['ms']:.4f} "
          f"(first design {r['ms_first']:.4f}); the replay alone (zero upstream) "
          f"{r['ms_replay']:.4f} (first design {r['ms_first_replay']:.4f}); the sweep's share "
          f"{r['ms'] - r['ms_replay']:.4f} (first design {r['ms_first'] - r['ms_first_replay']:.4f}) "
          f"G={r['lanes']} work_list={r['work_list']} registers={json.dumps(r['registers'])} "
          f"records bitwise={r['bitwise']} rel_err={json.dumps(r['rel_err'])}", flush=True)
    require(r["equal"], f"{label}: K8c's first design differs from the package's kernels")
    return r


def frame_against_first(mv, diff, frame, cfg_frame, dev) -> tuple:
    """``multi_scatter_and_grads`` at the frame point with the package's K8c
    and with its first design in its place, in four turns by ``time_ms``:
    their mean ms.  The first design runs where the wrapper's
    ``cuda_build.load("path_adjoint")`` is answered by
    csrc/path_adjoint_variants.cu's library set to it."""
    from deepestscatter_tpu_torch import cuda_build

    lib = mv.path_lib(cuda_build.load("path_adjoint_variants"))
    load = cuda_build.load

    def run():
        return diff.multi_scatter_and_grads(frame, cfg_frame, device=dev, **MS_FRAME)

    def run_first():
        lib.ds_path_variant(*mv.PATH_DESIGNS["first design (a thread an item)"])
        cuda_build.load = lambda name: lib if name == "path_adjoint" else load(name)
        try:
            return run()
        finally:
            cuda_build.load = load

    t = mv.in_turns({"package": run, "first": run_first}, 3, time_ms)
    return mv.mean(t["package"]), mv.mean(t["first"])


def ms_plain(diff, params, static, rays, inputs, kw, g, idx):
    """Autograd of the plain paths of pixels ``idx`` for the upstream
    ``g[:, idx]`` → (records, gradients of the six inputs; entry and dirs
    of ``idx`` only)."""
    leaves = [t.clone().requires_grad_(True) for t in inputs[:4]] + [
        t[idx].clone().requires_grad_(True) for t in inputs[4:]]
    p = params._replace(density_mips=(leaves[0],), inscatter=leaves[1], light_dir=leaves[2],
                        light_radiance=leaves[3])
    rec = diff.path_records_plain(p, static, leaves[4], leaves[5], rays.hit[idx], rays.ids[idx],
                                  kw["seed"], kw["n_subframes"])
    return rec.detach(), torch.autograd.grad(rec, leaves, g[:, idx].contiguous())


def ms_check(label, pt, diff, params, static, rays, inputs, kw, g, idx, deep_from=None):
    """K8c for the upstream ``g`` against autograd of the plain paths of
    ``idx`` (where ``g`` is 0 off ``idx``), its replay bitwise against K4's
    records, and the replay gate on the 64 deepest of ``idx`` (by K4's
    steps).  Returns (K8c's outputs, the errors, the plain ms, the
    re-marched steps)."""
    n_sub = kw["n_subframes"]
    remarch = torch.zeros((n_sub, rays.hit.shape[0]), dtype=torch.int32, device=g.device)
    got = ms_k8c(diff, params, static, rays, inputs, kw, g, remarch)
    rec = pt.launch_samples(diff._sample_params(inputs[0], inputs[1], params.phase), static,
                            inputs[4], inputs[5], rays.hit, rays.ids, kw["seed"], 1, n_sub)
    hit = rays.hit
    same = (torch.equal(got.records.radiance[:, hit], rec.radiance[:, hit])
            and torch.equal(got.records.work[:, hit], rec.work[:, hit]))
    print(f"{label}: K8c replay against K4's records: bitwise={same} samples="
          f"{int(hit.sum()) * n_sub} steps={int(rec.work[:, hit, 0].to(torch.int64).sum())} "
          f"in-box scatters={int(rec.work[:, hit, 1].to(torch.int64).sum())}", flush=True)
    require(same, f"{label}: K8c's replay differs from K4's records")
    (ref_rec, ref), plain_ms = host_call(
        lambda: ms_plain(diff, params, static, rays, inputs, kw, g, idx))
    check_errors(f"{label}: K4's records against the plain paths'", rel_errors(
        [("records", rec.radiance[:, idx], ref_rec)]), {"records": 1e-5})
    names = list(MS_TOL)
    got_v = [got.density, got.inscatter, got.light_dir, got.light_radiance, got.entry[idx],
             got.dirs[idx]]
    require(all(float(r.abs().max()) > 0 for r in ref),
            f"{label}: a reference gradient is zero on every checked path")
    errs = rel_errors(list(zip(names, got_v, ref)))
    check_errors(f"{label}: K8c against autograd of the plain paths", errs, MS_TOL)
    steps = rec.work[..., 0].to(torch.int64).sum(dim=0)[idx]
    order = torch.argsort(steps, descending=True)[:64]
    per_path = max(
        float(((a[idx][order] - b[order]).abs().amax(dim=1)
               / b[order].abs().amax(dim=1).clamp_min(1e-30)).max())
        for a, b in ((got.entry, ref[4]), (got.dirs, ref[5])))
    print(f"{label}: K8c replay gate on the 64 paths with the most steps "
          f"({int(steps[order].min())}-{int(steps[order].max())} steps over "
          f"{n_sub} samples): max per-path relative err of d/d entry and d/d dirs="
          f"{per_path:.3g} (tol {REPLAY_TOL:g})", flush=True)
    require(per_path <= REPLAY_TOL, f"{label}: K8c's error {per_path:.3g} on the deepest paths "
            f"is past {REPLAY_TOL:g}")
    return got, errs, plain_ms, rec, remarch


def k8c_work(rec, remarch, hit, n_voxels: int):
    """(bytes, operations) K8c needs for this run's paths: the two float32
    grids read and the two float64 gradients written once, a pixel's entry,
    direction, hit and id, a sample's upstream, record and gradients; the
    replay's steps, in-box scatters and samples, the sweep's re-marched
    steps and the scatters' adjoints."""
    n_sub, n = rec.work.shape[:2]
    samples = int(hit.sum()) * n_sub
    steps = int(rec.work[:, hit, 0].to(torch.int64).sum())
    bounces = int(rec.work[:, hit, 1].to(torch.int64).sum())
    remarched = int(remarch.to(torch.int64).sum())
    n_bytes = n_voxels * (4 + 4 + 8 + 8) + n * (12 + 12 + 1 + 8) + n * n_sub * (12 + 20 + 24)
    n_ops = (steps * K4_OPS_PER_STEP + bounces * (K4_OPS_PER_BOUNCE + K8C_OPS_PER_ADJOINT_BOUNCE)
             + samples * K4_OPS_PER_SAMPLE + remarched * K8C_OPS_PER_REMARCH_STEP)
    return n_bytes, n_ops, dict(samples=samples, steps=steps, bounces=bounces,
                                remarched_steps=remarched)


def phase_ms_diff(config, pt, ins_ops, dev) -> list:
    """The differentiable multi-scatter renderer: its main path counted
    (K3, K4, K8c and K8a must launch), K8c against the plain paths at both
    points, the timings; returns K8c's kernel row (at the frame point)."""
    from deepestscatter_tpu_torch.probes import march_variants as mv
    from deepestscatter_tpu_torch.render import diff

    t_phase = time.time()
    (small, cfg_small), (frame, cfg_frame) = ms_points(config, diff, dev)
    launchers = {"K3": ins_ops.sun_transmittance, "K4": pt.scatter_loop,
                 "K8c": diff.launch_path_adjoint, "K8a": diff.launch_bake_adjoint}

    # -- the main path, counted: the user's calls ------------------------------
    for f in launchers.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    small_out = diff.multi_scatter_and_grads(small, cfg_small, device=dev, **MS_SMALL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frame_img, frame_g = diff.multi_scatter_and_grads(frame, cfg_frame, device=dev, **MS_FRAME)
    torch.cuda.synchronize()
    frame_peak = torch.cuda.max_memory_allocated()
    launches = {k: f.launches for k, f in launchers.items()}
    print(f"ms diff: main path (multi_scatter_and_grads at the small and the frame point) "
          f"{time.time() - t0:.2f}s launches={json.dumps(launches)}", flush=True)
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the multi-scatter diff path never launched: {launches}")
    finite = bool(torch.isfinite(frame_img).all()) and all(
        bool(torch.isfinite(t).all()) for t in frame_g)
    nonzero = {k: float(getattr(frame_g, k).abs().max()) for k in ("density", "sun_dir", "eye")}
    print(f"ms diff frame: image_mean={frame_img.mean().item():.6g} finite={finite} "
          f"grad_max={json.dumps(nonzero)} peak_mem_mb={frame_peak / 2**20:.1f}", flush=True)
    require(finite, "ms diff frame: an image or gradient value is not finite")
    require(all(v > 0 for v in nonzero.values()), "ms diff frame: a gradient is zero")

    # -- the small point: K8c on every path ---------------------------------------
    img, g_small = small_out
    require(bool(torch.isfinite(img).all()) and all(bool(torch.isfinite(t).all())
                                                    for t in g_small),
            "ms diff small: an image or gradient value is not finite")
    params, static, rays, inputs = ms_paths(diff, small, cfg_small, MS_SMALL)
    n = rays.hit.shape[0]
    g = torch.from_numpy(np.random.default_rng(5).random((MS_SMALL["n_subframes"], n, 3))
                         .astype(np.float32)).to(dev)
    g = torch.where(rays.hit[None, :, None], g, 0.0).contiguous()
    all_hit = torch.nonzero(rays.hit).squeeze(1)
    _, _, plain_paths_small, rec_s, remarch_s = ms_check(
        "ms diff small", pt, diff, params, static, rays, inputs, MS_SMALL, g, all_hit)
    k8c_small = k8c_against_first("ms diff small", mv, diff, params, static, rays, inputs,
                                  MS_SMALL, g, 10)["ms"]
    fwd_small = time_ms(lambda: diff.render_multi_scatter_mc(small, cfg_small, device=dev,
                                                             **MS_SMALL), 5)
    both_small = time_ms(lambda: diff.multi_scatter_and_grads(small, cfg_small, device=dev,
                                                              **MS_SMALL), 5)
    b_s, o_s, w_s = k8c_work(rec_s, remarch_s, rays.hit, inputs[0].numel())
    print(f"ms diff small ({card_line()}): forward_ms={fwd_small:.3f} "
          f"forward+backward_ms={both_small:.3f} plain_forward+backward_ms of the paths="
          f"{plain_paths_small:.1f}; K8c ahead_ms={k8c_small:.4f} "
          f"bound_ms={max(b_s / HBM_BYTES_PER_S, o_s / F32_OPS_PER_S) * 1e3:.6f} "
          f"work={json.dumps(w_s)}", flush=True)
    del params, static, rays, inputs, g

    # -- the frame point: K8c on the 2,048 deepest paths, then its time -------
    params, static, rays, inputs = ms_paths(diff, frame, cfg_frame, MS_FRAME)
    n = rays.hit.shape[0]
    n_sub = MS_FRAME["n_subframes"]
    with torch.no_grad():
        rec = pt.launch_samples(diff._sample_params(inputs[0], inputs[1], params.phase), static,
                                inputs[4], inputs[5], rays.hit, rays.ids, MS_FRAME["seed"], 1,
                                n_sub)
    steps = torch.where(rays.hit, rec.work[..., 0].to(torch.int64).sum(dim=0), -1)
    deep = torch.argsort(steps, descending=True)[:MS_CHECK_PATHS]
    w = torch.zeros((n_sub, n, 3), dtype=torch.float32, device=dev)
    w[:, deep] = torch.from_numpy(np.random.default_rng(9).random((n_sub, deep.shape[0], 3))
                                  .astype(np.float32)).to(dev)
    got, errs, plain_deep_ms, _, _ = ms_check("ms diff frame", pt, diff, params, static, rays,
                                              inputs, MS_FRAME, w, deep)
    # The image mean's upstream on every path, as multi_scatter_and_grads
    # gives it: 1 / (3 N n_subframes) on each record of a pixel that hits.
    g = torch.where(rays.hit[None, :, None], 1.0 / (3 * n * n_sub), 0.0).to(
        torch.float32).expand(n_sub, n, 3).contiguous()
    remarch = torch.zeros((n_sub, n), dtype=torch.int32, device=dev)
    full = ms_k8c(diff, params, static, rays, inputs, MS_FRAME, g, remarch)
    k8c_frame = k8c_against_first("ms diff frame", mv, diff, params, static, rays, inputs,
                                  MS_FRAME, g, 3)["ms"]
    k8c_frame_events = time_ms(lambda: ms_k8c(diff, params, static, rays, inputs, MS_FRAME, g), 3)
    b_f, o_f, w_f = k8c_work(rec, remarch, rays.hit, inputs[0].numel())
    bound_f = max(b_f / HBM_BYTES_PER_S, o_f / F32_OPS_PER_S) * 1e3
    fwd_frame = time_ms(lambda: diff.render_multi_scatter_mc(frame, cfg_frame, device=dev,
                                                             **MS_FRAME), 3)
    both_frame = time_ms(lambda: diff.multi_scatter_and_grads(frame, cfg_frame, device=dev,
                                                              **MS_FRAME), 3)
    both_pkg, both_first = frame_against_first(mv, diff, frame, cfg_frame, dev)
    k4_frame = time_ms(lambda: pt.launch_samples(
        diff._sample_params(inputs[0], inputs[1], params.phase), static, inputs[4], inputs[5],
        rays.hit, rays.ids, MS_FRAME["seed"], 1, n_sub), 3)
    # The bake's forward (K3) and adjoint (K8a, on the in-scatter upstream
    # K8c gives it) at this point, by CUDA events.
    light = static.light_direction
    bake = (inputs[0], static.bbox, light, static.sample_step, static.density_multiplier)
    trans = ins_ops.launch_bake(*bake, early_out=False)
    k3_frame = time_ms(lambda: ins_ops.launch_bake(*bake, early_out=False), 3)
    g_insc = full.inscatter.to(torch.float32).reshape(-1).contiguous()
    adj = (inputs[0], static.bbox, light, static.density_multiplier, static.sample_step, trans,
           g_insc)
    k8a_frame = time_ms(lambda: diff.launch_bake_adjoint(*adj), 3)
    print(f"ms diff frame ({card_line()}): forward_ms={fwd_frame:.2f} "
          f"forward+backward_ms={both_frame:.2f} (in turns: {both_pkg:.2f}, with K8c's first "
          f"design {both_first:.2f}) K3_ms={k3_frame:.3f} K4_ms={k4_frame:.3f} "
          f"K8a_ms={k8a_frame:.3f} (voxels with an upstream {int((g_insc != 0).sum())}) "
          f"K8c ahead_ms={k8c_frame:.3f} (back to back {k8c_frame_events:.3f}) "
          f"bound_ms={bound_f:.4f} "
          f"({'bytes' if b_f / HBM_BYTES_PER_S >= o_f / F32_OPS_PER_S else 'operations'}) "
          f"plain_forward+backward_ms on the {MS_CHECK_PATHS} deepest paths={plain_deep_ms:.1f} "
          f"work={json.dumps(w_f)} peak_mem_mb={frame_peak / 2**20:.1f}", flush=True)
    phase_profile("ms diff frame profile",
                  lambda: diff.multi_scatter_and_grads(frame, cfg_frame, device=dev, **MS_FRAME),
                  both_frame)
    print(f"ms diff: phase {time.time() - t_phase:.1f}s", flush=True)
    row = kernel_row("K8c path adjoint", "deepestscatter_tpu_torch/csrc/path_adjoint.cu",
                     "deepestscatter_tpu/render/pathtracer.py:847", errs["density"][1],
                     k8c_frame, plain_deep_ms, b_f, o_f)
    return [dict(row, launches=launches["K8c"])]


#: The parallel phase: the operating point of PERF.md's PT cell at world 1;
#: the gloo worlds 2 and 4 (ranks sharing the card) on the 64^3 cumulus of
#: seed 11 at 128 x 64 pixels (PAR_SMALL); the training chunk's tables.
PAR_SMALL = (64, 128, 64)
PAR_CHECK_PIXELS = 2048
PAR_TRAIN = dict(n_rows=8192, batch=1024, steps=10)
PAR_TRAIN_SMALL = dict(n_rows=4096, batch=1024, steps=3)
#: The sharded tick at 2 subframes a tick against the unsharded one: the
#: JAX package's tolerances (tests/test_parallel.py:51-56).
PAR_TICK_TOL = {"mean": (1e-5, 1e-6), "m2": (1e-4, 1e-5)}


def records_close(out, ref, sr) -> float:
    """K9's records against the plain version's on the same inputs: depth,
    alive, touched and steps equal on every ray, the rest within 1e-5 of
    each column's largest value (at least 1) → the largest absolute
    difference of the radiance columns."""
    require(torch.equal(out[:, sr.DEPTH:], ref[:, sr.DEPTH:]),
            "K9 and its plain version took different decisions")
    scale = ref.abs().amax(dim=0).clamp(min=1.0)
    require(((out - ref).abs() / scale).max().item() <= 1e-5, "K9 disagrees with its plain version")
    return (out[:, sr.RAD:sr.RAD + 3] - ref[:, sr.RAD:sr.RAD + 3]).abs().max().item()


def k9_against_plain(sr, pt, params, static, entry, d, hit, ids, k4_steps):
    """K9 against ``spatial_phase_plain`` phase by phase on the
    PAR_CHECK_PIXELS pixels with the most K4 steps (one slab) → (max abs
    err, the plain version's ms over the subframe, phases)."""
    deep = torch.argsort(k4_steps, descending=True)[:PAR_CHECK_PIXELS]
    st = sr.phase_static(static)
    sc = sr.slab_scene(params, 0, 1, device=entry.device)
    spp = sr.default_steps_per_phase(static, static.grid_shape[0])
    seed = pt.rng_ops.subframe_seed(PT_SEED, 1)
    dids = ids[deep].contiguous()
    out = dict(err=0.0, plain_ms=0.0)

    def phase(rec, n_alive):
        k = sr.spatial_phase(sc, st, seed, dids, spp, rec, n_alive)
        ref, ms = host_call(lambda: sr.spatial_phase_plain(sc, st, seed, dids, spp, rec))
        out["plain_ms"] += ms
        out["err"] = max(out["err"], records_close(k, ref, sr))
        return sr.merge_slabs([k])

    rec0 = sr.begin_records(entry[deep], d[deep], hit[deep], params.bbox_size)
    _, phases, _ = sr.run_phases(rec0, phase, spp, static.max_total_steps)
    return out["err"], out["plain_ms"], phases


#: Calls a turn when K9 is timed against its first design (four turns).
K9_REPS = 3


def k9_against_first(mv, sr, cell) -> dict:
    """K9 against its first design (csrc/spatial_variants.cu) on the PT
    cell's replayed subframe (``march_variants.spatial_replay``), in four
    turns by ``ahead_ms`` (``march_variants.spatial_against_first``): a line
    a phase (the rays alive at its start, the package's lanes a ray, the
    steps marched, the longest ray's steps, the package's steps a lane and
    warp iteration (at most its chunks between refills times the lookahead
    at one lane a ray, 32; at most those chunks, 4, with G lanes),
    the SIMT efficiency a thread a ray has (rays by 32, each group as long
    as its longest ray), both designs' ms), then the subframe's; the first
    design's records bitwise the package's at every phase."""
    r = mv.spatial_against_first(cell, K9_REPS)
    for i, (out, n_alive, cnt) in enumerate(zip(cell["outs"], cell["alive"], cell["counters"])):
        steps = out[:, sr.STEPS]
        per_lane = float(steps.sum()) / (32.0 * max(cnt[1], 1))
        print(f"parallel K9 phase {i}: alive={n_alive} G={r['lanes'][i]} steps={int(steps.sum())} "
              f"longest={int(steps.max())} warp_iterations={cnt[1]} "
              f"steps_per_lane_iteration={per_lane:.3f} "
              f"simt_thread_a_ray={simt_per_pixel(steps):.3f} ms={r['phase_ms'][i]:.4f} "
              f"first_design_ms={r['phase_ms_first'][i]:.4f}", flush=True)
    print(f"parallel K9 against its first design ({card_line()}): the subframe's {len(cell['recs'])} "
          f"phases back to back ahead_ms={r['ms']:.4f} (first design {r['ms_first']:.4f}) "
          f"registers={json.dumps(r['registers'])} records bitwise={r['bitwise']}", flush=True)
    require(r["bitwise"], "K9's first design differs from the package's kernel")
    return r


def par_calls(config, world: int, small_cfg, dens, grid):
    """The jobs each rank of a gloo world runs (parallel.jobs.several)."""
    tick = [("tick", dict(cfg=dataclasses.replace(small_cfg, progressive=config.ProgressiveConfig(
        subframes_per_tick=s)), density=dens, seed=PT_SEED)) for s in (1, PT_SUBFRAMES)]
    shapes = [(1, world)] + ([(2, 2)] if world == 4 else [])
    calls = [("spatial", dict(cfg=small_cfg, density=dens, seed=PT_SEED, subframe=1,
                              mesh_shape=sh)) for sh in shapes]
    calls += [("halos", dict(grid=grid)), ("sharded_bake", dict(cfg=small_cfg, density=dens))]
    calls += tick
    if world == 2:
        calls.append(("train_chunk", PAR_TRAIN_SMALL))
    return calls, shapes


def phase_parallel(port, config, procedural, pt, ins_ops, dev) -> list:
    """Multi-device rendering and training (E2): world 1 over NCCL at the
    PT cell, counted (K3, K4, K9 and K10 must launch); then gloo worlds 2
    and 4 sharing the card at PAR_SMALL.  Returns K9's kernel row."""
    import torch.distributed as dist

    from deepestscatter_tpu_torch.parallel import jobs, launch, make_mesh
    from deepestscatter_tpu_torch.parallel import spatial
    from deepestscatter_tpu_torch.parallel import spatial_render as sr
    from deepestscatter_tpu_torch.parallel.render import ShardedProgressiveRenderer
    from deepestscatter_tpu_torch.probes import march_variants as mv
    from deepestscatter_tpu_torch.render import camera as cam
    from deepestscatter_tpu_torch.train import device_data as dd

    t_phase = time.time()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{launch.free_port()}",
                            world_size=1, rank=0)
    try:
        # -- the main path at world 1, counted -------------------------------------
        launchers = {"K3": ins_ops.sun_transmittance, "K4": pt.scatter_loop,
                     "K9": sr.spatial_phase, "K10": dd.assemble_disney}
        for f in launchers.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        cfg, params, static = pt_scene(port, config, procedural, 256, dev)
        mesh = make_mesh(device_type="cuda")
        mesh_ds = make_mesh((1, 1), ("data", "space"), device_type="cuda")
        cfg1 = dataclasses.replace(cfg, progressive=config.ProgressiveConfig(subframes_per_tick=1))
        ticks = {s: ShardedProgressiveRenderer(c, params, static, mesh, seed=PT_SEED, device=dev)
                 for s, c in ((1, cfg1), (PT_SUBFRAMES, cfg))}
        for r in ticks.values():
            r.tick()
        scene_sl = sr.shard_scene(mesh_ds, params, device=dev)
        fn = sr.make_spatial_subframe(mesh_ds, static)
        o, d = cam.generate_rays(cam.camera_basis(cfg.camera), PT_SIZE, PT_SIZE, dev)
        ids = torch.arange(o.shape[0], device=dev)
        spatial_out = fn(scene_sl, o, d, PT_SEED, 1, ids)
        phases, k9_steps = fn.last_phases, fn.last_steps
        baked_sharded = spatial.sharded_inscatter_bake(mesh, params, static, device=dev)
        train_dp = jobs.train_chunk(**PAR_TRAIN, device=dev)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in launchers.items()}
        print(f"parallel: main path at world 1 over {dist.get_backend()} on "
              f"{torch.cuda.get_device_name(0)} ({time.time() - t0:.2f}s: PT cell build and "
              f"bake, sharded ticks at 1 and {PT_SUBFRAMES} subframes, a spatial subframe of "
              f"{phases} phases, the sharded bake, a data-parallel chunk) "
              f"launches={json.dumps(launches)}", flush=True)
        require(all(n > 0 for n in launches.values()),
                f"a kernel of the multi-device path never launched: {launches}")

        # -- against the one-device paths --------------------------------------------
        for s, c in ((1, cfg1), (PT_SUBFRAMES, cfg)):
            one = port.ProgressiveRenderer(c, params, static, seed=PT_SEED, device=dev)
            one.tick()
            st = ticks[s].state
            diffs = {f: (getattr(st, f) - getattr(one.state, f)).abs().max().item()
                     for f in ("mean", "m2", "count")}
            same = all(torch.equal(getattr(st, f), getattr(one.state, f))
                       for f in ("mean", "m2", "count"))
            print(f"parallel tick at {s} subframe(s), world 1 against ProgressiveRenderer: "
                  f"bitwise={same} max_diff={json.dumps(diffs)}", flush=True)
            if s == 1:
                require(same, "the single-subframe sharded tick is not bitwise the unsharded")
            for f, (rtol, atol) in PAR_TICK_TOL.items():
                require(torch.allclose(getattr(st, f), getattr(one.state, f), rtol=rtol,
                                       atol=atol), f"the sharded tick's {f} is off")
        hit, t_hit = cam.intersect_box(o, d, static, params.bbox_size)
        entry = cam.entry_points(o, d, t_hit, params.bbox_size)
        seed = pt.rng_ops.subframe_seed(PT_SEED, 1)
        k4 = pt.scatter_loop(params, static, entry, d, hit, ids, seed, 0, 1)
        ref_sub = pt.render_subframe(params, static, o, d, PT_SEED, 1, ids, device=dev)
        capped = hit & (k4.steps >= static.max_total_steps)
        ok = ~capped
        same = torch.equal(spatial_out[ok], ref_sub[ok])
        print(f"parallel spatial subframe (K9, world 1, {PT_SIZE}^2) against render_subframe "
              f"(K4): bitwise={same} on {int(ok.sum())} pixels; {int(capped.sum())} pixels "
              f"whose K4 sample reached its step cap left out; max_diff="
              f"{(spatial_out - ref_sub).abs().max().item():.3g} phases={phases} "
              f"steps={k9_steps} (K4 {int(k4.steps.sum())})", flush=True)
        require(same, "the spatial subframe is not bitwise K4's")
        whole = port.bake(params, static, device=dev)
        require(torch.equal(baked_sharded, whole), "the sharded bake is not bitwise the bake")
        train_one = jobs.train_chunk(**PAR_TRAIN, distributed=False, device=dev)
        same_train = (torch.equal(train_dp["losses"], train_one["losses"])
                      and torch.equal(train_dp["params"], train_one["params"]))
        print(f"parallel sharded bake bitwise=True; data-parallel chunk ({PAR_TRAIN}) against "
              f"the undistributed chunk: bitwise={same_train} K10_launches="
              f"{train_dp['k10_launches']}", flush=True)
        require(same_train, "the data-parallel chunk at world 1 is not the undistributed chunk")
        err, plain_ms, plain_phases = k9_against_plain(sr, pt, params, static, entry, d, hit, ids,
                                                       torch.where(hit, k4.steps, -1))
        print(f"parallel K9 against spatial_phase_plain on the {PAR_CHECK_PIXELS} pixels with "
              f"the most steps: {plain_phases} phases, max_abs_err={err:.3g} (decisions equal, "
              f"values within 1e-5 of each column's largest) plain_ms={plain_ms:.1f}", flush=True)

        # -- times (CUDA events: the profiler saw nothing here late in a full run) --
        sub = lambda: fn(scene_sl, o, d, PT_SEED, 1, ids)  # noqa: E731
        cell = mv.spatial_replay(scene_sl, static, seed, ids, entry, d, hit)
        k9 = k9_against_first(mv, sr, cell)
        k9_ms = k9["ms"]
        group = mesh_ds.get_group("space")
        merge_ms = time_ms(lambda: [sr.owner_merge(out, group) for out in cell["outs"]], 3)
        sub_host_ms = float(np.median([host_ms(sub) for _ in range(3)]))
        k4_ms = time_ms(lambda: pt.scatter_loop(params, static, entry, d, hit, ids, seed, 0, 1),
                        3)
        tick_sh = float(np.median([host_ms(ticks[PT_SUBFRAMES].tick) for _ in range(3)]))
        one = port.ProgressiveRenderer(cfg, params, static, seed=PT_SEED, device=dev)
        tick_one = float(np.median([host_ms(one.tick) for _ in range(3)]))
        print(f"parallel times ({card_line()}): one {PT_SIZE}^2 subframe at world 1: K9 "
              f"ms={k9_ms:.3f} (ahead_ms) over its {phases} phases, the merges (owner_merge: the masked "
              f"all_reduce and wheres) ms={merge_ms:.3f} (CUDA events, replayed back to back), "
              f"host_ms={sub_host_ms:.3f}; K4 ms for the same subframe={k4_ms:.3f}; "
              f"a {PT_SUBFRAMES}-subframe tick host_ms sharded={tick_sh:.3f} "
              f"unsharded={tick_one:.3f}", flush=True)
        phase_profile("parallel spatial subframe profile", sub, sub_host_ms)

        # -- the world-1 references of the gloo worlds ------------------------------
        res, w, h = PAR_SMALL
        small_cfg = dataclasses.replace(cfg, camera=config.CameraConfig(width=w, height=h))
        dens = procedural.cumulus(resolution=res, seed=11)
        ref_spatial = jobs.spatial(small_cfg, dens, PT_SEED, 1, (1, 1), device=dev)
        ref_bake = jobs.sharded_bake(small_cfg, dens, device=dev)["whole"]
        ref_ticks = [jobs.tick(dataclasses.replace(small_cfg, progressive=config.ProgressiveConfig(
            subframes_per_tick=s)), dens, PT_SEED, device=dev) for s in (1, PT_SUBFRAMES)]
        ref_train = jobs.train_chunk(**PAR_TRAIN_SMALL, device=dev)
    finally:
        dist.destroy_process_group()

    # -- gloo worlds 2 and 4, sharing the card ----------------------------------------
    grid = np.random.default_rng(1).random((64, 8, 8)).astype(np.float32)
    for world in (2, 4):
        t0 = time.time()
        calls, shapes = par_calls(config, world, small_cfg, dens, grid)
        out = launch.run("deepestscatter_tpu_torch.parallel.jobs:several", world, device="cuda",
                         backend="gloo", timeout=300, calls=calls)
        where = sorted({(r[0]["backend"], r[0]["device"]) for r in out})
        for k, shape in enumerate(shapes):
            n_space = shape[1]
            got = torch.cat([out[g * n_space][k]["radiance"] for g in range(shape[0])])
            same = torch.equal(got, ref_spatial["radiance"])
            slabs = sorted({r[k]["slab"] for r in out})
            print(f"parallel world {world} ({shape[0]} data x {n_space} space): spatial "
                  f"subframe bitwise to world 1={same} phases={[r[k]['phases'] for r in out]} "
                  f"slabs={slabs}", flush=True)
            require(same, f"the spatial render on a {shape} mesh differs from world 1")
        k = len(shapes)
        halos = all(torch.equal(r[k]["exchange"], r[k]["scatter"]) for r in out)
        bake_ok = all(torch.equal(r[k + 1]["sharded"], ref_bake.cpu()) for r in out)
        tick_ok = [all(torch.equal(out[0][k + 2 + j][f], ref_ticks[j][f])
                       for f in ("mean", "m2", "count")) for j in range(2)]
        print(f"parallel world {world} over {where}: exchange_halos==scatter {halos}, sharded "
              f"bake bitwise {bake_ok}, ticks at 1 and {PT_SUBFRAMES} subframes bitwise to world "
              f"1 {tick_ok} ({time.time() - t0:.1f}s)", flush=True)
        require(halos and bake_ok and all(tick_ok), f"a world-{world} check failed")
        if world == 2:
            tr = out[0][k + 4]
            rel = float(torch.linalg.norm(tr["params"] - ref_train["params"])
                        / torch.linalg.norm(ref_train["params"]))
            lmax = float((tr["losses"] - ref_train["losses"]).abs().max()
                         / ref_train["losses"].abs().max())
            pmax = float((tr["params"] - ref_train["params"]).abs().max())
            print(f"parallel world 2 training chunk ({PAR_TRAIN_SMALL}) against world 1: "
                  f"losses rel {lmax:.3g} (tol 1e-4), params norm-rel {rel:.3g} (tol 1e-3), "
                  f"max {pmax:.3g} (tol 2 lr x steps)", flush=True)
            require(lmax <= 1e-4 and rel <= 1e-3
                    and pmax <= 2 * 1e-3 * PAR_TRAIN_SMALL["steps"],
                    "the world-2 training chunk is off world 1's")
    print(f"parallel: phase {time.time() - t_phase:.1f}s", flush=True)
    n = entry.shape[0]
    tex = 2 * params.density_mips[0].numel() * params.density_mips[0].element_size()
    tables = (params.phase.eval_rows.numel() + params.phase.inv_cdf_rows.numel()) * 4
    n_bytes = tex + tables + n * (12 + 12 + 1 + 8) + n * 12
    n_hit = int(hit.sum().item())
    n_ops = (k9_steps * K4_OPS_PER_STEP + int(k4.bounces.sum().item()) * K4_OPS_PER_BOUNCE
             + n_hit * K4_OPS_PER_SAMPLE)
    row = kernel_row("K9 slab march", "deepestscatter_tpu_torch/csrc/spatial.cu",
                     "deepestscatter_tpu/parallel/spatial_render.py:351", err, k9_ms, plain_ms,
                     n_bytes, n_ops)
    return [dict(row, launches=launches["K9"], first_design_ms=k9["ms_first"])]


#: The skip phase: ticks of each timed progressive render, the deepest
#: pixels (most lattice steps) K4 is held to its plain version on, and the
#: seed of the skipping renders (independent of the default render's).
SKIP_TICKS = 16
SKIP_CHECK_PIXELS = 1024
SKIP_SEED = PT_SEED + 10
SKIP_RES = (256, 64)


def skip_statics(static) -> dict:
    """The scene's static without a skip, with the cell jump alone and with
    the block skip alone (as the scene built it)."""
    base = dataclasses.replace(static, occupancy_skip_steps=0, march_empty_skip=False)
    return {"default": base, "cell": dataclasses.replace(base, march_empty_skip=True),
            "block": static}


def k4_subframes_job(pt, params, static, entry, d, hit, ids):
    """K4 on the tick's samples of the given pixels, once a subframe (1 ..
    PT_SUBFRAMES, a sample each) → (its moments, the job of its plain
    version for ``run_plain_jobs``: the plain loop once over every (pixel,
    subframe) lane side by side, the same paths as the tick's, in the
    iterations of its longest sample)."""
    ks = [pt.scatter_loop(params, static, entry, d, hit, ids, PT_SEED, s, 1)
          for s in range(1, PT_SUBFRAMES + 1)]
    k = pt.PixelMoments(*(torch.cat(f) for f in zip(*ks)))
    lanes = [t.repeat(PT_SUBFRAMES, *([1] * (t.dim() - 1))) for t in (entry, d, hit, ids)]
    sub = torch.arange(1, PT_SUBFRAMES + 1, device=ids.device).repeat_interleave(ids.shape[0])
    return k, dict(fn=PLAIN_PT, args=(params, static, *lanes, PT_SEED, sub, 1))


def k4_subframes_check(k, r) -> tuple:
    """K4's moments ``k`` against its plain version's ``r`` → (max abs
    err, share of lanes with equal steps).  Tolerance: step, scatter and
    jumped-step counts equal on every lane; mean within 1e-5 of its
    largest value."""
    same = (k.steps == r.steps) & (k.jumped == r.jumped)
    share = same.float().mean().item()
    err = (k.mean - r.mean).abs().max().item()
    ok = (torch.equal(k.count, r.count) and share == 1.0 and torch.equal(k.bounces, r.bounces)
          and err <= 1e-5 * (r.mean.abs().max().item() + 1e-12))
    require(ok, f"K4 disagrees with its plain version (steps and jumps equal on {share:.6f})")
    return err, share


#: Seconds a plain job's worker may take (each took 20-45 s on the card's
#: host).
PLAIN_JOB_SECONDS = 600
#: The plain versions the skip phase runs in workers ("module:function").
PLAIN_PT = "deepestscatter_tpu_torch.render.pathtracer:scatter_loop_plain"
PLAIN_SAMPLES = "deepestscatter_tpu_torch.data.collectors:generate_scatter_samples_plain"


def plain_job(path: str) -> None:
    """A worker process: the plain version of the job ``torch.save``d at
    ``path`` (``fn``: "module:function", ``args``) → its result and host ms
    at ``path`` + ".out"."""
    import importlib

    job = torch.load(path, weights_only=False)
    module, name = job["fn"].split(":")
    fn = getattr(importlib.import_module(module), name)
    r, ms = host_call(lambda: fn(*job["args"]))
    torch.save(dict(result=r, ms=ms), path + ".out")


def run_plain_jobs(jobs: dict) -> dict:
    """Each plain job of ``jobs`` (key → a ``plain_job`` job) in a worker
    process of its own, all at once (each is bound by its host's launches,
    one an op, and the card serves them side by side) → key → (its result,
    host ms).  Every worker is joined or terminated."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_plain_")
    procs = {}
    try:
        for i, (key, job) in enumerate(jobs.items()):
            path = os.path.join(tmp, f"job{i}.pt")
            torch.save(job, path)
            proc = ctx.Process(target=plain_job, args=(path,))
            proc.start()
            procs[key] = (proc, path)
        out = {}
        for key, (proc, path) in procs.items():
            proc.join(PLAIN_JOB_SECONDS)
            require(proc.exitcode == 0, f"the plain job {key} failed (exit {proc.exitcode})")
            r = torch.load(path + ".out", weights_only=False)
            out[key] = (r["result"], r["ms"])
        return out
    finally:
        for proc, _ in procs.values():
            if proc.is_alive():
                proc.terminate()
            proc.join()
        shutil.rmtree(tmp, ignore_errors=True)


#: The cell jump's designs the skip phase times (march_variants.JUMP_DESIGNS'
#: codes): the first (a jump ends its lookahead chunk) and the package's.
SKIP_JUMP_DESIGNS = ("first design", "package")
#: Kernels whose ptxas report the skip phase prints beside the jump's times.
JUMP_PTXAS = {"pathtrace": ("pathtrace_items_kernel<2,u8,1>", "pathtrace_items_kernel<2,f32,1>",
                            "radiance_items_kernel<2,u8,1>", "radiance_items_kernel<2,f32,1>"),
              "pathtrace_variants": ("jump_items_kernel<0,2,u8>", "jump_items_kernel<0,2,f32>",
                                     "jump_radiance_kernel<0,2,u8>",
                                     "jump_radiance_kernel<0,2,f32>")}


def jump_ptxas() -> dict:
    """The ptxas registers and spills of the cell jump's kernels, the
    package's and the first design's (``JUMP_PTXAS``), from the build logs."""
    from deepestscatter_tpu_torch import cuda_build
    from deepestscatter_tpu_torch.probes import march_variants as mv

    out = {}
    for src, names in JUMP_PTXAS.items():
        log = cuda_build.BUILD_DIR / f"{src}.log"
        found = mv.ptxas(log.read_text()) if log.is_file() else {}
        out.update({k: found.get(k) for k in names})
    return out


def jump_against_first(label: str, cell: dict, reps: int, radiance: bool) -> dict:
    """The cell jump's package kernel against its first design on a cell of
    ``march_variants.k4_jump_cell`` / ``k7b_lanes_cell``, beside the kernel
    without a skip, in four turns by ``ahead_ms``
    (``march_variants.jump_compare``): a line with each one's ms, warp
    march iterations, SIMT efficiency, steps sampled and jumped, the jumps
    and lattice steps a jump, registers and spills; both designs bitwise."""
    from deepestscatter_tpu_torch import cuda_build
    from deepestscatter_tpu_torch.probes import march_variants as mv

    lib = mv.jump_lib(cuda_build.load("pathtrace_variants"))
    r = mv.jump_compare(lib, cell, {k: mv.JUMP_DESIGNS[k] for k in SKIP_JUMP_DESIGNS}, reps,
                        radiance)
    new, first, base = r["package"], r["first design"], r["default"]
    print(f"{label}, against its first design (in turns, ahead_ms): ms={new['ms']:.4f} "
          f"first_design_ms={first['ms']:.4f} default_ms={base['ms']:.4f} "
          f"turns={json.dumps({k: r[k]['turns'] for k in ('package', 'first design', 'default')})} "
          f"warp_iterations={new['warp_iterations']} "
          f"first_design_warp_iterations={first['warp_iterations']} "
          f"default_warp_iterations={base['march_slots'] // mv.lib_const(lib, 'ds_jump_lookahead')} "
          f"simt_efficiency={new['simt_efficiency']:.4f} "
          f"first_design_simt_efficiency={first['simt_efficiency']:.4f} "
          f"default_simt_efficiency={base['simt_efficiency']:.4f} "
          f"steps_sampled={new['steps']} steps_jumped={new['jumped']} "
          f"default_steps={base['steps']} jumps={r['jumps']} "
          f"lattice_steps_per_jump={r['lattice_steps_per_jump']:.4f} "
          f"registers={new['registers']} local_bytes={new['local_bytes']} "
          f"first_design_registers={first['registers']} "
          f"first_design_local_bytes={first['local_bytes']} bitwise_equal={first['equal']} "
          f"ptxas={json.dumps(jump_ptxas())}", flush=True)
    require(first["equal"] and new["equal"],
            f"{label}: the first design differs from the package's")
    return r


#: K4's block-skip designs the skip phase times (march_variants.BLOCK_DESIGNS'
#: codes): the first (the float32 occupancy read at every step) and the
#: package's.
SKIP_BLOCK_DESIGNS = ("first design", "package")


def block_against_first(label: str, cell: dict, reps: int) -> dict:
    """K4's block skip, the package's kernel against its first design on a
    cell of ``march_variants.k4_block_cell``, beside the kernel without a
    skip, in four turns by ``ahead_ms`` (``march_variants.block_compare``):
    a line with each one's ms, warp march iterations, SIMT efficiency,
    steps sampled and jumped, registers and spills; both designs
    bitwise."""
    from deepestscatter_tpu_torch import cuda_build
    from deepestscatter_tpu_torch.probes import march_variants as mv

    lib = mv.block_lib(cuda_build.load("pathtrace_variants"))
    r = mv.block_compare(lib, cell, {k: mv.BLOCK_DESIGNS[k] for k in SKIP_BLOCK_DESIGNS}, reps)
    new, first, base = r["package"], r["first design"], r["default"]
    print(f"{label}, against its first design (in turns, ahead_ms): ms={new['ms']:.4f} "
          f"first_design_ms={first['ms']:.4f} default_ms={base['ms']:.4f} "
          f"turns={json.dumps({k: r[k]['turns'] for k in ('package', 'first design', 'default')})} "
          f"warp_iterations={new['warp_iterations']} "
          f"first_design_warp_iterations={first['warp_iterations']} "
          f"default_warp_iterations={base['warp_iterations']} "
          f"simt_efficiency={new['simt_efficiency']:.4f} "
          f"first_design_simt_efficiency={first['simt_efficiency']:.4f} "
          f"default_simt_efficiency={base['simt_efficiency']:.4f} "
          f"steps_sampled={new['steps']} steps_jumped={new['jumped']} "
          f"default_steps={base['steps']} registers={new['registers']} "
          f"local_bytes={new['local_bytes']} blocks_per_sm={new['blocks_per_sm']} "
          f"first_design_registers={first['registers']} "
          f"first_design_local_bytes={first['local_bytes']} bitwise_equal={first['equal']}",
          flush=True)
    require(first["equal"] and new["equal"],
            f"{label}: the first design differs from the package's")
    return r


def samples_against_first(label: str, params, default, cell, n: int, reps: int) -> dict:
    """K7a's cell jump, the package's kernel against its first design
    (csrc/march_variants.cu: rounds of 8 warps, each attempt in chunks of
    32 lanes), beside the kernel without a skip, on ``n`` samples in four
    turns by ``ahead_ms`` (``march_variants.samples_compare``): a line with
    each one's ms, steps and attempts; the first design bitwise the
    package's."""
    from deepestscatter_tpu_torch import cuda_build
    from deepestscatter_tpu_torch.probes import march_variants as mv

    lib = mv.cell_samples_lib(cuda_build.load("march_variants"))
    r = mv.samples_compare(lib, params, default, cell, n, 0,
                           {"first design": mv.CELL_SAMPLE_DESIGNS["first design"]}, reps)
    new, first, base = r["package library"], r["first design"], r["default"]
    print(f"{label}, against its first design (in turns, ahead_ms): ms={new['ms']:.4f} "
          f"first_design_ms={first['ms']:.4f} default_ms={base['ms']:.4f} "
          f"turns={json.dumps({k: r[k]['turns'] for k in ('package library', 'first design', 'default')})} "
          f"steps={new['steps']} attempts={new['attempts']} attempts_max={new['attempts_max']} "
          f"default_steps={base['steps']} bitwise_equal={first['equal']}", flush=True)
    require(first["equal"], f"{label}: the first design differs from the package's")
    return r


def skip_pt(port, config, procedural, pt, cam, res, dev) -> dict:
    """The PT cell at ``res``^3 with the occupancy built: per static of
    ``skip_statics`` a progressive render of SKIP_TICKS ticks as a user
    drives it (K4's launches counted), its Mrays/s, K4's tick by CUDA
    events and its steps sampled and jumped; each skip's K4 on the
    SKIP_CHECK_PIXELS deepest pixels' samples with the job of its plain
    version (``k4_subframes_job``; ``skip_pt_check`` holds them and the
    images); the cell jump's kernel against its first design
    (``jump_against_first``).  Also returns the scene (``"scene"``)."""
    from deepestscatter_tpu_torch.probes import march_variants as mv

    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=PT_SIZE, height=PT_SIZE),
        rendering=config.CloudRendering(march_dtype="uint8", occupancy_skipping=True),
        progressive=config.ProgressiveConfig(subframes_per_tick=PT_SUBFRAMES),
    )
    params, static = port.build_scene(cfg, procedural.cumulus(resolution=res, seed=11), device=dev)
    params = port.with_baked_inscatter(params, static, device=dev)
    statics = skip_statics(static)
    occ = params.occupancy
    print(f"skip PT {res}^3: occupancy={tuple(occ.shape)} empty_blocks="
          f"{float((occ < 0.5).float().mean()):.4f} long_step={static.occupancy_skip_steps} "
          f"lattice steps", flush=True)
    entry, d, hit, ids = pt_rays(cam, params, static, dev)
    args = (entry, d, hit, ids, PT_SEED, 1, PT_SUBFRAMES)
    out = {}
    for name, st in statics.items():
        pt.scatter_loop.launches = 0
        torch.cuda.synchronize()
        r = port.ProgressiveRenderer(cfg, params, st, device=dev,
                                     seed=PT_SEED if name == "default" else SKIP_SEED)
        r.tick()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SKIP_TICKS):
            r.tick()
        torch.cuda.synchronize()
        tick_s = (time.perf_counter() - t0) / SKIP_TICKS
        launches = pt.scatter_loop.launches
        stt = r.state
        image = (stt.mean.reshape(PT_SIZE, PT_SIZE, 3).cpu().numpy(),
                 stt.m2.reshape(PT_SIZE, PT_SIZE, 3).cpu().numpy(),
                 stt.count.reshape(PT_SIZE, PT_SIZE).cpu().numpy())
        work = pt.scatter_loop(params, st, *args)
        ms = time_ms(lambda: pt.scatter_loop(params, st, *args), 5)
        out[name] = dict(tick_s=tick_s, ms=ms, launches=launches, image=image,
                         steps=int(work.steps.sum()), jumped=int(work.jumped.sum()),
                         bounces=int(work.bounces.sum()), image_mean=float(image[0].mean()))
        require(bool(np.isfinite(image[0]).all()), f"skip PT {res}^3 {name}: non-finite")
        require(launches == SKIP_TICKS + 1, f"skip PT {res}^3 {name}: K4 launched {launches} "
                f"times in {SKIP_TICKS + 1} ticks")
        if name != "default":
            deep = torch.topk((work.steps + work.jumped).to(torch.float64),
                              SKIP_CHECK_PIXELS).indices.sort().values
            out[name]["kernel"], out[name]["job"] = k4_subframes_job(
                pt, params, st, *(t[deep].contiguous() for t in (entry, d, hit, ids)))
        del work
    out["cell"]["jump"] = jump_against_first(
        f"skip PT {res}^3 cell jump", mv.k4_jump_cell(params, statics["default"], entry, d, hit,
                                                       ids, PT_SEED, 1, PT_SUBFRAMES), 5, False)
    out["block"]["against"] = block_against_first(
        f"skip PT {res}^3 block skip",
        mv.k4_block_cell(params, statics["default"], statics["block"], entry, d, hit, ids,
                         PT_SEED, 1, PT_SUBFRAMES), 5)
    tex = 2 * params.density_mips[0].numel() * params.density_mips[0].element_size()
    tables = (params.phase.eval_rows.numel() + params.phase.inv_cdf_rows.numel()) * 4
    n, n_hit = entry.shape[0], int(hit.sum().item())
    for name in ("cell", "block"):
        o = out[name]
        o["bytes"] = (tex + tables + ((occ.numel() + 31) // 32 * 4 if name == "block" else 0)
                      + n * (12 + 12 + 1 + 8) + n * (12 + 12 + 4 + 16 + 8))
        o["ops"] = (o["steps"] * K4_OPS_PER_STEP + o["bounces"] * K4_OPS_PER_BOUNCE
                    + n_hit * PT_SUBFRAMES * K4_OPS_PER_SAMPLE)
        o["default_ms"] = out["default"]["ms"]
    out["scene"] = (params, static)
    return out


def skip_pt_check(compare, res, out, plain) -> None:
    """``skip_pt``'s cell at ``res``^3 with its plain jobs' results
    ``plain`` (skip → (moments, host ms)): a line a static; each skip's K4
    bitwise its plain version (``k4_subframes_check``) and its image
    against the default image by ``render_agreement`` (independent seeds;
    a 1.02-scaled image must fail)."""
    rays = PT_SIZE * PT_SIZE * PT_SUBFRAMES
    base = out["default"]
    for name in ("default", "cell", "block"):
        o = out[name]
        line = (f"skip PT {res}^3 {name}: Mrays_per_s={rays / o['tick_s'] / 1e6:.3f} "
                f"s_per_tick={o['tick_s']:.6f} K4_ms={o['ms']:.4f} (default {base['ms']:.4f}) "
                f"steps_sampled={o['steps']} steps_jumped={o['jumped']} bounces={o['bounces']} "
                f"lattice_steps={o['steps'] + o['jumped']} image_mean={o['image_mean']:.6f} "
                f"K4_launches={o['launches']}")
        if name != "default":
            rs, plain_ms = plain[name]
            err, share = k4_subframes_check(o.pop("kernel"), rs)
            o.update(plain_ms=plain_ms, err=err)
            image = o["image"]
            a = compare.render_agreement(*image, base["image"][0], reference_noise=1.0)
            sc = compare.render_agreement(EVAL_SCALE * image[0], EVAL_SCALE**2 * image[1],
                                          image[2], base["image"][0], reference_noise=1.0)
            line += (f"; against its plain version on the {SKIP_CHECK_PIXELS} deepest pixels' "
                     f"{PT_SUBFRAMES * SKIP_CHECK_PIXELS} samples (lattice steps "
                     f"{int((rs.steps + rs.jumped).min())}..{int((rs.steps + rs.jumped).max())} "
                     f"a sample): steps_jumps_scatters_equal="
                     f"{share:.6f} max_abs_err={err:.3g} plain_ms={plain_ms:.1f} (in a worker "
                     f"beside the other plain jobs); against the "
                     f"default image (seeds {SKIP_SEED} and {PT_SEED}, {SKIP_TICKS + 1} ticks "
                     f"each): mean_z={a.mean_z:.3f} (tol 4) tone_mapped_rms={a.rms:.6g} "
                     f"noise_expected_rms={a.noise_rms:.6g} (tol 1.5x) "
                     f"past_4_sigma_share={a.past_4_sigma:.6f} passes={a.passes()}; scaled by "
                     f"{EVAL_SCALE}: mean_z={sc.mean_z:.1f} passes={sc.passes()} (must be False)")
            require(a.passes(), f"skip PT {res}^3 {name}: the image disagrees with the default")
            require(not sc.passes(), f"skip PT {res}^3 {name}: the gate passes a scaled image")
            require(o["jumped"] > 0, f"skip PT {res}^3 {name}: no step was skipped")
        print(line, flush=True)
    for name in ("default", "cell", "block"):
        out[name].pop("image")


def phase_skip(port, config, cuda_build, procedural, collectors, march_ops, pt, cam,
               dev) -> list:
    """Empty-space skipping on the main paths, counted (K4, K7b, K7a and K1
    must launch their skipping instantiations): the PT cell at 256^3 and
    64^3 (``skip_pt``); the collector's scene (COLLECT_CLOUD, its 2,048
    stored samples' first radiance update) with the cell jump, K7b held to
    its plain version by ``k7b_against_plain`` from base 0; K7a's 2,048
    samples with each skip bitwise its plain version (attempts and steps
    equal); the RPNN frame with the block skip, its two K1 passes against
    ``camera_march_plain`` (``phase_k1``).  The plain versions of K4's,
    K7b's and K7a's checks run side by side in worker processes once the
    card's timings are taken (``run_plain_jobs``).  Each row: its time
    beside the default's of the same call, launches, the bound from the
    steps it sampled, the plain time."""
    from deepestscatter_tpu_torch import tasks
    from deepestscatter_tpu_torch.data import records
    from deepestscatter_tpu_torch.models.rpnn import init_disney_model
    from deepestscatter_tpu_torch.probes import march_variants as mv
    from deepestscatter_tpu_torch.utils import compare

    rows = []
    pt_out = {res: skip_pt(port, config, procedural, pt, cam, res, dev) for res in SKIP_RES}
    jobs = {("K4", res, name): pt_out[res][name].pop("job")
            for res in SKIP_RES for name in ("cell", "block")}

    # -- the collector's scene: K7b with the cell jump, K7a with each skip ----
    n = records.BATCH_SIZE
    setup = np.zeros(1, records.SCENE_SETUP)
    setup[0] = (COLLECT_CLOUD.encode(), COLLECT_SIZE_M, config.LIGHT_DIRECTIONS["Front"])
    base_cfg = tasks.production_base()
    base_cfg = dataclasses.replace(base_cfg, rendering=dataclasses.replace(
        base_cfg.rendering, occupancy_skipping=True))
    _, params, static = tasks.scene_from_setup(setup[0], base=base_cfg, device=dev)
    statics = skip_statics(static)
    ref_s = collectors.generate_scatter_samples(params, statics["default"], n, 0)
    pos, dirs = ref_s.positions, ref_s.directions
    rcfg = config.PointRadianceConfig()
    cell = statics["cell"]
    collectors.radiance_moments.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    est = collectors.estimate_point_radiance(params, cell, pos, dirs, rcfg, seed=0, max_updates=1)
    torch.cuda.synchronize()
    upd_s = time.time() - t0
    k7b_launches = collectors.radiance_moments.launches
    require(k7b_launches == 1 and bool(np.isfinite(est.radiance).all()),
            f"skip K7b: {k7b_launches} launches, or a label not finite")
    gen = torch.Generator().manual_seed(17)
    kb = k7b_against_plain(collectors, pt, params, cell, pos, dirs, rcfg, (0,), gen, defer=True)
    jobs["K7b"] = kb.pop("job")
    rsd, rsc = (collectors.radiance_static(statics[k]) for k in ("default", "cell"))
    entry = kb["entry"]
    margs = (entry, dirs, torch.arange(n, dtype=torch.int64, device=dev),
             torch.zeros(n, dtype=torch.int64, device=dev), 0, kb["replicas"], kb["launches"])
    ms_b = time_ms(lambda: collectors.radiance_moments(params, rsc, *margs), 3)
    ms_bd = time_ms(lambda: collectors.radiance_moments(params, rsd, *margs), 3)
    o, d, ids, sub0 = collectors._lanes(entry, dirs, margs[2], margs[3], kb["replicas"],
                                        kb["launches"])
    pm, _ = collectors.launch_radiance(params, rsc, o, d, ids, sub0, 0, kb["launches"])
    pmd, _ = collectors.launch_radiance(params, rsd, o, d, ids, sub0, 0, kb["launches"])
    steps_b, jumped_b, bounces_b = (int(getattr(pm, f).sum()) for f in ("steps", "jumped",
                                                                         "bounces"))
    default_b = (int(pmd.steps.sum()), int(pmd.bounces.sum()))
    jr = jump_against_first("skip K7b cell jump",
                            mv.k7b_lanes_cell(params, rsd, (o, d, ids, sub0), 0, kb["launches"]),
                            3, True)
    del pm, pmd, est, o, d, ids, sub0

    ms_ad = device_ms(lambda: collectors.generate_scatter_samples(params, statics["default"], n,
                                                                  0),
                      10, "samples_rounds_kernel")
    k7a = {}
    for name in ("cell", "block"):
        st = statics[name]
        collectors.generate_scatter_samples.launches = 0
        k = collectors.generate_scatter_samples(params, st, n, 0)
        torch.cuda.synchronize()
        launches = collectors.generate_scatter_samples.launches
        if name == "cell":
            turns = samples_against_first("skip K7a cell jump", params, statics["default"], st,
                                          n, 20)
            ms_a = turns["package library"]["ms"]
        else:
            turns = None
            ms_a = device_ms(lambda: collectors.generate_scatter_samples(params, st, n, 0), 10,
                             "samples_rounds_kernel")
        k7a[name] = (k, launches, ms_a, turns)
        jobs["K7a", name] = dict(fn=PLAIN_SAMPLES, args=(params, st, n, 0))

    # -- the plain versions, side by side in workers --------------------------
    t0 = time.time()
    plain = run_plain_jobs(jobs)
    print(f"skip plain jobs: {len(plain)} in workers side by side, {time.time() - t0:.1f}s",
          flush=True)
    for res in SKIP_RES:
        skip_pt_check(compare, res, pt_out[res], {name: plain["K4", res, name] for name in
                                                   ("cell", "block")})
    pt_out[SKIP_RES[1]].pop("scene")
    for name, label in (("cell", "cell jump"), ("block", "block skip")):
        o, lo = pt_out[SKIP_RES[0]][name], pt_out[SKIP_RES[1]][name]
        row = kernel_row(f"K4 path-trace bounce loop, {label}",
                         "deepestscatter_tpu_torch/csrc/pathtrace.cu",
                         "deepestscatter_tpu/render/pathtracer.py:"
                         + ("277" if name == "cell" else "772"),
                         max(o["err"], lo["err"]), o["ms"], o["plain_ms"], o["bytes"], o["ops"])
        row.update(launches=o["launches"] + lo["launches"], default_ms=o["default_ms"],
                   steps_sampled=o["steps"], steps_jumped=o["jumped"],
                   ms_64=lo["ms"], default_ms_64=lo["default_ms"], steps_sampled_64=lo["steps"],
                   steps_jumped_64=lo["jumped"],
                   bound_ms_64=kernel_row("", "", "", 0, 0, 0, lo["bytes"], lo["ops"])["bound_ms"])
        key = "jump" if name == "cell" else "against"
        row.update(first_design_ms=o[key]["first design"]["ms"],
                   first_design_ms_64=lo[key]["first design"]["ms"],
                   ms_in_turns=o[key]["package"]["ms"],
                   ms_in_turns_64=lo[key]["package"]["ms"],
                   default_ms_in_turns=o[key]["default"]["ms"],
                   default_ms_in_turns_64=lo[key]["default"]["ms"])
        if name == "block":
            for sfx, r in (("", o[key]), ("_64", lo[key])):
                row.update({f"warp_iterations{sfx}": r["package"]["warp_iterations"],
                            f"first_design_warp_iterations{sfx}":
                                r["first design"]["warp_iterations"],
                            f"default_warp_iterations{sfx}": r["default"]["warp_iterations"],
                            f"simt_efficiency{sfx}": r["package"]["simt_efficiency"],
                            f"first_design_simt_efficiency{sfx}":
                                r["first design"]["simt_efficiency"],
                            f"registers{sfx}": r["package"]["registers"],
                            f"first_design_registers{sfx}": r["first design"]["registers"]})
        rows.append(row)

    kb = k7b_plain_finish(kb, *plain["K7b"])
    print(f"skip K7b cell jump: points={n} lanes={kb['lanes']} experiments="
          f"{kb['lanes'] * kb['launches']} update_s(estimate_point_radiance, 1 update)="
          f"{upd_s:.3f} launches={k7b_launches} ms={ms_b:.3f} default_ms={ms_bd:.3f} "
          f"steps_sampled={steps_b} steps_jumped={jumped_b} bounces={bounces_b} "
          f"default_steps={default_b[0]} default_bounces={default_b[1]}; "
          f"folds_equal_records={kb['fold_counts_ok']} fold_err={kb['fold_err']:.3g}; "
          f"{K7B_CHECKED} records against one-experiment plain runs: steps_scatters_equal="
          f"{kb['counts_eq']} max_abs_err={kb['err']:.3g} (tol 1e-5 of max) "
          f"longest_steps={kb['longest_steps']} plain_ms={kb['plain_ms']:.1f} (in a worker)",
          flush=True)
    require(kb["ok"], "skip K7b: the cell jump disagrees with its plain version")
    require(jumped_b > 0, "skip K7b: no step was jumped")
    tex = params.density_mips[0].numel() * params.density_mips[0].element_size()
    tables = (params.phase.eval_rows.numel() + params.phase.inv_cdf_rows.numel()) * 4
    n_lanes = kb["lanes"]
    row = kernel_row("K7b radiance experiments, cell jump",
                     "deepestscatter_tpu_torch/csrc/pathtrace.cu",
                     "deepestscatter_tpu/render/pathtracer.py:277", kb["err"], ms_b,
                     kb["plain_ms"],
                     2 * tex + tables + n_lanes * (12 + 12 + 8 + 4) + n_lanes * (12 + 12 + 4 + 16 + 8),
                     steps_b * K4_OPS_PER_STEP + bounces_b * K4_OPS_PER_BOUNCE
                     + n_lanes * kb["launches"] * K4_OPS_PER_SAMPLE)
    row.update(launches=k7b_launches, default_ms=ms_bd, steps_sampled=steps_b,
               steps_jumped=jumped_b, first_design_ms=jr["first design"]["ms"],
               ms_in_turns=jr["package"]["ms"])
    rows.append(row)
    del kb

    for name, label in (("cell", "cell jump"), ("block", "block skip")):
        k, k7a_launches, ms_a, turns = k7a[name]
        r, plain_a = plain["K7a", name]
        unequal = [f for f, a, b in zip(r._fields, k, r) if not torch.equal(a, b)]
        steps_a, att_a = int(k.steps.sum()), int(k.attempts.sum())
        found_same = bool(torch.equal(k.found, ref_s.found))
        timing = "in turns, ahead_ms" if turns else "device, profiler"
        default_a = turns["default"]["ms"] if turns else ms_ad
        print(f"skip K7a {label}: samples={n} launches={k7a_launches} found={int(k.found.sum())} "
              f"ms({timing})={ms_a:.4f} default_ms={default_a:.4f} steps_sampled={steps_a} "
              f"default_steps={int(ref_s.steps.sum())} attempts={att_a} "
              f"default_attempts={int(ref_s.attempts.sum())} found_as_default={found_same} "
              f"fields_not_bitwise_equal={unequal} (required: none) plain_ms={plain_a:.1f} "
              f"(in a worker)", flush=True)
        require(k7a_launches == 1 and not unequal,
                f"skip K7a {label}: differs from its plain version in {unequal}")
        err_a = (k.positions - r.positions).abs().max().item()
        row = kernel_row(f"K7a first-scatter sampler, {label}",
                         "deepestscatter_tpu_torch/csrc/samples.cu",
                         "deepestscatter_tpu/ops/march.py:" + ("244" if name == "cell" else "199"),
                         err_a, ms_a, plain_a,
                         tex + (params.occupancy.numel() * 4 if name == "block" else 0)
                         + n * (12 + 12 + 1 + 8),
                         steps_a * K7A_OPS_PER_STEP + att_a * K7A_OPS_PER_ATTEMPT)
        row.update(launches=k7a_launches, default_ms=default_a, steps_sampled=steps_a)
        if turns:
            row.update(first_design_ms=turns["first design"]["ms"], ms_in_turns=ms_a,
                       default_profiler_ms=ms_ad)
        rows.append(row)
    del params, ref_s, pos, dirs, k7a, plain

    # -- the RPNN frame with the block skip: K1's two passes ------------------
    # The PT cell's 256^3 scene is the RPNN frame's (the same cloud, size,
    # textures and occupancy; the camera is the frame's).
    basis = cam.camera_basis(config.CameraConfig(width=WIDTH, height=HEIGHT))
    params, static = pt_out[SKIP_RES[0]].pop("scene")
    block = skip_statics(static)["block"]
    default = skip_statics(static)["default"]
    renderer = port.DisneyRenderer(init_disney_model(SEED_WEIGHTS, device=dev), device=dev)
    march_ops.camera_march.launches = 0
    frame = renderer.render_frame(params, block, WIDTH, HEIGHT, basis, seed=2)
    torch.cuda.synchronize()
    k1_launches = march_ops.camera_march.launches
    ref_frame = renderer.render_frame(params, default, WIDTH, HEIGHT, basis, seed=2)
    diff = (frame - ref_frame).abs().max().item()
    same = (frame == ref_frame).all(dim=-1).float().mean().item()
    finite = bool(torch.isfinite(frame).all())
    o, dd = cam.generate_rays(basis, WIDTH, HEIGHT, dev)
    hit, t_hit = cam.intersect_box(o, dd, static, params.bbox_size)
    idx = torch.nonzero(hit).flatten()
    entry = cam.entry_points(o, dd, t_hit, params.bbox_size)[idx].contiguous()
    dirs = dd[idx].contiguous()
    row, _, _ = phase_k1(march_ops, cuda_build, params, block, entry, dirs, idx,
                         label="skip K1 block skip")
    ms_d = time_ms(lambda: march_ops.camera_march(params, default, entry, dirs), 5)
    ms_b1 = time_ms(lambda: march_ops.camera_march(params, block, entry, dirs), 5)
    print(f"skip K1 frame: launches={k1_launches} (2 a frame) frame_finite={finite} "
          f"pixels_equal_default={same:.6f} "
          f"max_abs_diff_default={diff:.3g}; pass 1 ms={ms_b1:.4f} default_ms={ms_d:.4f}",
          flush=True)
    require(k1_launches == 2 and finite, f"skip K1: {k1_launches} launches, or a frame not finite")
    row.update(name="K1 camera march + NEE, block skip", launches=k1_launches,
               replaces="deepestscatter_tpu/ops/march.py:199", pass1_ms=ms_b1,
               default_pass1_ms=ms_d)
    rows.append(row)
    return rows


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

    # -- the differentiable renderer's main path, counted ------------------------
    kernels += phase_diff(port, config, prog, ins_ops, dev)

    # -- the differentiable multi-scatter renderer's main path, counted ---------
    kernels += phase_ms_diff(config, pt, ins_ops, dev)

    # -- multi-device rendering and training, counted ---------------------------
    kernels += phase_parallel(port, config, procedural, pt, ins_ops, dev)

    # -- empty-space skipping on the main paths, counted -------------------------
    kernels += phase_skip(port, config, cuda_build, procedural, collectors, march_ops, pt, cam,
                          dev)
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
