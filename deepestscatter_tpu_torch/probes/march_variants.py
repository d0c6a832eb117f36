"""Alternatives of the package's march and descriptor kernels, timed on
one card.

``csrc/march_variants.cu`` builds, beside the kernels the package runs:

- K4 (``csrc/pathtrace.cu``) with its item queue at each lookahead in
  ``QUEUE_LOOKAHEADS``, and as one thread per pixel over its samples at
  each lookahead in ``PIXEL_LOOKAHEADS``; lookahead 0 is that mapping with
  the march it had before the queue (``trace_sample``: int64 tap offsets,
  IEEE divisions by the box size);
- K3 (``csrc/inscatter.cu``) with each number of voxels a thread in
  ``VOXELS``;
- K1 (``csrc/march.cu``) in each design of ``K1_DESIGNS``: each number of
  lanes a ray in ``LANES``, 0 being its first design, one thread per ray
  over ``march_ray`` (int64 taps, IEEE divisions by the box size in the
  step loop), reported with its SIMT efficiency (rays in groups of 32, each
  group as long as its longest ray);
- K2 (``csrc/descriptor.cu``) in each design of ``DESCRIPTOR``: one thread
  per output element (its first design), the package's thread per point
  and column with the light frame computed a thread, and the same with the
  frame staged in shared memory;
- K7a (``csrc/samples.cu``) in each design of ``K7A_DESIGNS``: rounds of
  W attempts a sample (W warps a block; the package runs
  ``kSampleWarps``), and its first design, a group of G lanes a sample
  walking its attempts in order (G = 32; G = 8 is K1's lanes a ray),
  reported with the rounds the longest sample took;
- K7b (``csrc/pathtrace.cu::ds_radiance``) in each design of
  ``K7B_DESIGNS``: its first design (K4's item queue with a per-lane
  experiment base) and the deferred scatters at each number of parked
  lanes and lookahead, reported with the SIMT efficiency of the march
  (steps over 32 x march slots) and the crossings a resolve step handles;
- K8a and K8b's adjoint (``csrc/diff.cu``, built from
  ``csrc/diff_variants.cu``, which includes only that source) in each
  design of ``K8A_DESIGNS`` and ``K8B_DESIGNS``: K8a as a thread a voxel
  (its first design) and as rows of V voxels a thread; K8b's adjoint as a
  thread a ray (its first design) and with G lanes a ray; and, for the first
  design and the package's, with its grid scatters aimed at a scratch
  slot of its own a thread and left out (``SCATTERS``): what its atomics
  and its arithmetic each cost; K8a's first design likewise.  K8b's
  forward in each design of ``FORWARD_DESIGNS`` (a thread a ray, its first
  design, and G lanes a ray) at both points and in pointwise mode at the
  defaults point.  Then K8b's adjoint at G = 8, 16 and 32 and its forward
  in each design on the frame point's cloud at the smaller frames of
  ``LANE_POINTS``, around the ray counts where the package's lanes a ray
  change (``ds_diff_lanes``, ``ds_diff_forward_lanes``); the sun march and
  its adjoint in each design of ``SUN_DESIGNS`` (a thread a point, their
  first design; the package's thread a point; G lanes a point), the
  adjoint's atomics left out too, at each count of ``SUN_POINTS`` in each
  of ``SUN_ORDERS``.

- K8c (``csrc/path_adjoint.cu``, built from ``csrc/path_adjoint_variants.cu``,
  which includes only that source and the first design's header) in each
  design of ``PATH_DESIGNS``: its first design (a thread a (sample,
  pixel)), the replay and the sweep at other lanes a sample and launch
  bounds, and the sweep's atomics aimed at a scratch slot or left out; at
  chip_smoke.py's multi-scatter frame point (the 256^3 cumulus of seed 11
  at 2000 m, 512 x 256, ``max_depth`` 4, 2 subframes, the image mean's
  upstream), each also with a zero upstream (the replay alone), beside K4
  on the same samples, in turns by ``ahead_ms``; each design's records
  bitwise against the package's and its gradients within ``PATH_TOL``;
  then the package's sweep timed entry by entry (``path_timeline``).

- The cell jump of K4 and K7b (``csrc/pathtrace.cu`` with ``kSkipCell``,
  built from ``csrc/pathtrace_variants.cu``, which includes only that
  source) in each design of ``JUMP_DESIGNS``: its first design (a jump ends
  its lookahead chunk, the exit by ten divisions), the package's (the jump
  inside the chunk, the exit from a face table), a probe that takes the
  first design's exits and discards them, and the jump inside the chunk
  with divided exits; at chip_smoke.py's PT cell at 256^3 and 64^3 and at
  the collector's first radiance update, beside the kernel without a skip,
  in turns by ``ahead_ms``, with steps sampled and jumped, the jumps and
  lattice steps a jump, warp iterations, SIMT efficiency, registers and
  spills; every design bitwise the package's (the probe the default's).

- K9 (``csrc/spatial.cu``, built from ``csrc/spatial_variants.cu``, which
  includes only that source and the first design's header) in each design
  of ``SPATIAL_DESIGNS``: its first design (a thread a ray), the package's
  queue at each G lanes a ray, with other launch bounds and chunks between
  refills, and scanning in order; phase by phase at chip_smoke.py's PT
  cell (the 512^2 subframe at world 1, one slab, seed 5's first subframe)
  and at 1024^2, each phase timed alone in turns by ``ahead_ms``, beside K4
  on the same samples, every design bitwise against the package's.

The diff kernels run at chip_smoke.py's two points of ``render.diff``:
the defaults point (64 x 32, 256 steps of 1/256, dm 100, the 64^3 cloud
of seed 29, baked) and the frame point (the 256^3 cumulus of seed 11, 512
x 256, 896 steps of 1/512, dm 200, baked), on the main path's inputs
(K8b's upstream that of the image mean, K8a's the baked grid's gradient
from K8b's adjoint); each alternative with its scatters in place against
the package's kernel (K8a within 1e-12 of the density gradient's largest
value, K8b's adjoint within 1e-5 of each leaf's largest).  Their times
are CUDA-event means with the host enqueueing ahead of the card
(``ahead_ms``: a launch at the defaults point is shorter than its
wrapper's host time), the alternatives timed in turns as below; the
forwards bitwise against the package's kernel.  chip_smoke.py times the
package's kernels against their first designs through ``against_first``,
``forward_against_first`` and ``sun_against_first``.

Every other alternative runs at the main paths' operating point (the 256^3
procedural cumulus of seed 11, 2000 m, uint8 textures; K4 on the 512^2
tick of 2 subframes, K3 on the whole grid with early-out, K1 on both passes
of the 512 x 256 neural frame's rays, K2 on that frame's shading points in
one launch; K7a on the dataset collector's 2,048 samples of that cloud
with the ``Front`` light, as ``tasks.collect`` prepares it; K7b on the
radiance stage's first update there: 2,048 points x 10 replicas, 100
experiments a lane, bases 0) and must equal the package's kernel bitwise
(K7b: records and folds).  Times are CUDA-event means over 20 calls (K4,
K1, K2, K7a) or 3 (K3, K7b), the alternatives timed in turns, forward then
backward, twice.

Run on the card::

    python -m deepestscatter_tpu_torch.probes.march_variants [--collector-only | --diff-only |
                                                              --path-only | --spatial-only |
                                                              --jump-only | --skip-only]

``--collector-only`` runs K7a's and K7b's alternatives alone,
``--diff-only`` K8a's, K8b's, the sun march's and K8c's, ``--path-only``
K8c's alone, ``--spatial-only`` K9's alone, ``--jump-only`` the cell
jump's of K4 and K7b alone, ``--skip-only`` K4's block skip's (at the PT
cell's 256^3 and 64^3) and K7a's cell jump's (on the collector's 2,048
samples) alone (the default run leaves K8c's, K9's and the skips' out).  Prints
one line an alternative, then one JSON object as the last line; exits 1
without a card or if an alternative disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from .. import config, cuda_build, tasks
from ..data import collectors, procedural, records
from ..ops import descriptor, march
from ..render import camera, inscatter, pathtracer
from ..render.inscatter import with_baked_inscatter
from ..scene import build_scene

QUEUE_LOOKAHEADS = (1, 2, 4, 8)
PIXEL_LOOKAHEADS = (0, 1, 2)
VOXELS = (1, 2, 4, 8)
LANES = (0, 4, 8, 16, 32)
#: K1's alternatives: lanes a ray by name, 0 for a thread per ray.  The
#: package runs 8 lanes.
K1_DESIGNS = {"one thread per ray": 0, **{f"G={g}": g for g in LANES if g}}
#: K2's alternatives: the design by name.
DESCRIPTOR = {"element": 0, "column": 1, "column_staged_frame": 2}
SIZE = 512
SUBFRAMES = 2
#: K7a's alternatives: (warps a sample in rounds, or 0 and the lanes of a
#: sample walking its attempts in order) by name.
K7A_DESIGNS = {"rounds W=2": (2, 0), "rounds W=4": (4, 0), "rounds W=8": (8, 0),
               "rounds W=16": (16, 0), "first design G=32": (0, 32), "G=8": (0, 8)}
#: K7b's alternatives: (design, parked lanes, lookahead) by name; design 0
#: is K4's item queue (its first design), 1 the deferred scatters.
K7B_DESIGNS = {"first design (items)": (0, 24, 2),
               **{f"deferred P={p}": (1, p, 2) for p in (8, 16, 18, 20, 22, 24, 28)},
               "deferred P=20 K=1": (1, 20, 1), "deferred P=20 K=4": (1, 20, 4)}
#: The neural frame (chip_smoke.py's): 512 x 256.
NEURAL_WIDTH, NEURAL_HEIGHT = 512, 256
#: K8a's alternatives (``ds_diff_variant``'s codes): 0 a thread a voxel
#: (its first design); the row kernel with V voxels a thread, each lane's
#: runs by float64 atomics (the package runs ``kAdjVoxels``).
K8A_DESIGNS = {"first design (a thread a voxel)": 0, **{f"rows V={v}": v for v in (1, 2, 4)}}
#: K8b's adjoint: 0 a thread a ray (its first design), G lanes a ray (the
#: package runs ``ds_diff_lanes(rays)``: 32 where every ray's 32 lanes fit
#: the card's thread slots, else 8).
K8B_DESIGNS = {"first design (a thread a ray)": 0, **{f"G={g}": g for g in (4, 8, 16, 32)}}
#: Its grid scatters: atomics into the grids, a scratch slot a thread, none.
SCATTERS = {"atomics": 0, "scratch slot": 1, "no atomics": 2}
#: K8b's forward: 0 a thread a ray (its first design), G lanes a ray (the
#: package runs ``ds_diff_forward_lanes(rays)``).
FORWARD_DESIGNS = {"first design (a thread a ray)": 0, **{f"G={g}": g for g in (4, 8, 16, 32)}}
#: The sun march and its adjoint: 0 a thread a point (their first design),
#: 1 the package's thread a point, G lanes a point (``csrc/diff_variants.cu``).
SUN_DESIGNS = {"first design (a thread a point)": 0,
               "a thread a point (strided samples; the adjoint's runs merged)": 1,
               **{f"G={g}": g for g in (8, 16, 32)}}
#: The sun march's points: the 64^3 cloud's voxel centres, the first n in
#: voxel order (a slab of z-slices: neighbouring threads on neighbouring
#: points, as the voxel centres and a frame's NEE points in pixel order
#: come) or n at random: where lanes a point and a thread a point each win.
SUN_POINTS = (2048, 8192, 32768, 131072, 262144)
SUN_ORDERS = ("voxel", "random")
#: The sun march's density multiplier, steps and step (chip_smoke.py's).
SUN_ARGS = (100.0, 128, 1.0 / 256.0)
#: chip_smoke.py's multi-scatter frame point: the 256^3 cumulus of seed 11
#: at 2000 m, the scene configuration's sun and eye, light 1e6, 512 x 256,
#: max_depth 4, 2 subframes, seed 0.
MS_FRAME = dict(width=512, height=256, max_depth=4, n_subframes=2, seed=0)
#: K8c's alternatives (``csrc/path_adjoint_variants.cu``, ``ds_path_variant``'s
#: codes: the design (0 the first, 1 the two kernels), lanes a sample, the
#: replay's launch bounds' resident blocks a SM (0 for the threads alone,
#: -1 for the package's), the sweep (-1 the kernel of those; at the
#: package's lanes: 6 resident blocks a SM in its launch bounds, 101 its
#: scatters into a scratch slot a thread, 102 none)): its first design (a
#: thread an item, both passes), the two kernels at each G and at other
#: launch bounds, and the sweep's atomics' share.
PATH_DESIGNS = {"first design (a thread an item)": (0, 8, -1, -1),
                **{f"G={g}": (1, g, -1, -1) for g in (4, 8, 16, 32)},
                "G=8 replay blocks=0": (1, 8, 0, -1),
                "G=8 sweep blocks=6": (1, 8, -1, 6),
                "G=8 sweep scatters into a scratch slot": (1, 8, -1, 101),
                "G=8 sweep without scatters": (1, 8, -1, 102)}
#: K8c's outputs and the tolerances an alternative keeps against the
#: package's (of each one's largest value): the density 1e-5, the others
#: 1e-4 (K8c's own against the plain paths).
PATH_LEAVES = ("density", "inscatter", "light_dir", "light_radiance", "entry", "dirs")
PATH_TOL = {f: 1e-5 if f == "density" else 1e-4 for f in PATH_LEAVES}
#: chip_smoke.py's diff points: (cloud resolution, seed, sun, eye, render
#: arguments); the sun and eye None for the scene configuration's.
DIFF_POINTS = {
    "defaults": (64, 29, (-0.3, -0.9, 0.1), (2.5, -0.4, 0.0), {}),
    "frame": (256, 11, None, None,
              dict(width=512, height=256, density_multiplier=200.0, n_steps=896,
                   sample_step=1.0 / 512.0, remat_chunk=32)),
}
#: The frame point's cloud and march at smaller frames (width, height):
#: 4,096 to 65,536 rays, around the count where K8b's adjoint's lanes a
#: ray switch from 32 to 8 (past 8,448 rays on 132 SMs: rays x 32 above
#: the card's thread slots).
LANE_POINTS = {f"frame {w}x{h}": (w, h)
               for w, h in ((64, 64), (128, 64), (128, 128), (256, 128), (256, 256))}
#: K8b's adjoint's leaves (baked or to_sun None by the in-scatter mode).
LEAVES = ("density", "baked", "to_sun", "entry", "dirs", "p_phase")


def time_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: Clock cycles a call the card spins for before the calls ahead_ms times
#: (torch.cuda._sleep; about 0.2 ms a call); four times as many after a
#: try in which the host fell behind, for at most AHEAD_TRIES tries.
AHEAD_CYCLES_PER_CALL = 400_000
AHEAD_TRIES = 4


def ahead_ms(fn: Callable[[], object], reps: int) -> float:
    """``fn``'s mean device time over ``reps`` calls after one warm-up, by
    CUDA events with the host ahead of the card: a spin kernel holds the
    stream while the host enqueues the events and the calls, so that the
    events see the calls back to back and not the wrapper's host time
    between them.  The start event must still be pending once every call
    is enqueued (the spin outlasted the enqueueing); where it is not, the
    calls are timed again behind a spin four times as long.  Raises if the
    host falls behind AHEAD_TRIES times."""
    fn()
    torch.cuda.synchronize()
    cycles = AHEAD_CYCLES_PER_CALL * reps
    for _ in range(AHEAD_TRIES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        ahead = not start.query()
        end.record()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        print(f"ahead_ms: the host fell behind a spin of {cycles} cycles; timing again",
              flush=True)
        cycles *= 4
    raise RuntimeError(f"ahead_ms: the host fell behind the card {AHEAD_TRIES} times")


def in_turns(fns: Dict[str, Callable[[], object]], reps: int,
             timer: Callable[[Callable[[], object], int], float] = time_ms
             ) -> Dict[str, List[float]]:
    """Each function's time by ``timer``, measured forward then backward
    over the keys, twice."""
    ms: Dict[str, List[float]] = {k: [] for k in fns}
    keys = list(fns)
    for k in (keys + keys[::-1]) * 2:
        ms[k].append(timer(fns[k], reps))
    return ms


def ptxas(log: str) -> Dict[str, List[str]]:
    """Registers and spills of each templated kernel in an nvcc ``-Xptxas
    -v`` log, by ``name<template arguments>`` (u8/f32 for the texel type)."""
    out: Dict[str, List[str]] = {}
    name = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", ln)
        if m:
            n = int(m.group(1))
            base, rest = m.group(2)[:n], m.group(2)[n:]
            targs = re.match(r"I(.*?)Ev", rest)
            args = re.findall(r"Li(\d+)E|([hf])", targs.group(1)) if targs else []
            words = [num or {"h": "u8", "f": "f32"}[t] for num, t in args]
            name = f"{base}<{','.join(words)}>"
            out[name] = []
        elif name and ("spill" in ln or "Used" in ln):
            out[name].append(ln.split("ptxas info    : ")[-1].strip())
    return out


def simt_per_pixel(steps: torch.Tensor) -> float:
    """SIMT efficiency of one thread per pixel: pixels in groups of 32,
    each group marching as long as its longest pixel."""
    s = steps.to(torch.float64)
    s = torch.cat([s, s.new_zeros((-s.numel()) % 32)]).reshape(-1, 32)
    return float(s.sum() / (32.0 * s.amax(dim=1).sum()))


def neural_inputs(params, static, dev):
    """The neural frame's march passes and shading points, as chip_smoke.py
    drives K1 and K2: pass 1 over the box hits, pass 2 over its T < 1 rays
    (seed 1), the points where pass 2 scattered in the box."""
    basis = camera.camera_basis(config.CameraConfig(width=NEURAL_WIDTH, height=NEURAL_HEIGHT))
    o, d = camera.generate_rays(basis, NEURAL_WIDTH, NEURAL_HEIGHT, dev)
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    idx = torch.nonzero(hit).flatten()
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)[idx].contiguous()
    dirs = d[idx].contiguous()
    pass1 = (entry, dirs, 0, None, None)
    t1 = march._launch(params, static, *pass1).transmittance
    sel = torch.nonzero(t1 < 1.0).flatten()
    pass2 = (entry[sel].contiguous(), dirs[sel].contiguous(), 1, idx[sel].contiguous(),
             t1[sel].contiguous())
    m2 = march._launch(params, static, *pass2)
    points = (m2.scatter_pos[m2.ok].contiguous(), pass2[1][m2.ok].contiguous())
    return pass1, pass2, points


def k1_variants(lib, params, static, pass1, pass2) -> Dict[str, dict]:
    """K1 in each design of K1_DESIGNS against the package's, both passes."""
    refs, steps, simt = [], [], []
    for a in (pass1, pass2):
        refs.append(march._launch(params, static, *a))
        steps.append(int(march.camera_march.last_counters[1].item()))
        od = torch.zeros(a[0].shape[0], device=a[0].device)
        simt.append(simt_per_pixel(march.next_scattering_event(params, static, od, *a[:2]).steps))
    out: Dict[str, dict] = {}
    fns = {}
    for key, g in K1_DESIGNS.items():
        def run(g=g):
            lib.ds_neural_variant(g, 1)  # (K2's choice unused here)
            return [march._launch(params, static, *a, lib=lib) for a in (pass1, pass2)]

        got = run()
        equal = all(all(x is None and y is None or torch.equal(x, y) for x, y in zip(a, b))
                    for a, b in zip(got, refs))
        row = dict(equal=equal)
        if g == 0:
            row["simt_efficiency"] = simt
        else:
            row["lane_utilisation"] = []
            for a in (pass1, pass2):
                march._launch(params, static, *a, lib=lib)
                slots, n_steps = (int(v) for v in march.camera_march.last_counters.tolist())
                row["lane_utilisation"].append(n_steps / slots)
        out[key] = row
        fns[key] = run
    for key, ms in in_turns(fns, 20).items():
        out[key]["ms"] = ms
        print(f"K1 {key}: {json.dumps(out[key])}", flush=True)
    out["steps"] = steps
    return out


def k2_variants(lib, params, static, points) -> Dict[str, dict]:
    """K2 in each design of DESCRIPTOR against the package's, one launch."""
    ref = descriptor._launch(params, static, *points)
    out: Dict[str, dict] = {}
    fns = {}
    for key, design in DESCRIPTOR.items():
        def run(design=design):
            lib.ds_neural_variant(8, design)  # (K1's lanes unused here)
            return descriptor._launch(params, static, *points, lib=lib)

        out[key] = dict(equal=torch.equal(run(), ref))
        fns[key] = run
    for key, ms in in_turns(fns, 20).items():
        out[key]["ms"] = ms
        print(f"K2 {key}: {json.dumps(out[key])}", flush=True)
    return out


def collector_scene(dev, bake: bool):
    """The collector's scene: ``procedural:256:11`` at 2000 m with the
    ``Front`` light, prepared as ``tasks.collect`` prepares it."""
    setup = np.zeros(1, records.SCENE_SETUP)[0]
    setup["cloud_path"] = b"procedural:256:11"
    setup["cloud_size_m"] = 2000.0
    setup["light_direction"] = config.LIGHT_DIRECTIONS["Front"]
    _, params, static = tasks.scene_from_setup(setup, bake=bake, device=dev)
    return params, static


def k7a_variants(lib, params, static) -> Dict[str, dict]:
    """K7a in each design of K7A_DESIGNS against the package's, on the
    collector's scene and batch."""
    n = records.BATCH_SIZE
    ref = collectors._launch_samples(params, static, n, 0)
    att = ref.attempts
    out: Dict[str, dict] = {}
    fns = {}
    for key, (warps, lanes) in K7A_DESIGNS.items():
        def run(warps=warps, lanes=lanes):
            lib.ds_samples_variant(warps, lanes)
            return collectors._launch_samples(params, static, n, 0, lib=lib)

        row = dict(equal=all(torch.equal(a, b) for a, b in zip(run(), ref)))
        if warps:
            rounds = (att + warps - 1) // warps
            row.update(rounds_mean=float(rounds.float().mean()), rounds_max=int(rounds.max()))
        out[key] = row
        fns[key] = run
    for key, ms in in_turns(fns, 20).items():
        out[key]["ms"] = ms
        print(f"K7a {key}: {json.dumps(out[key])}", flush=True)
    out["attempts"] = dict(mean=float(att.float().mean()), max=int(att.max()))
    return out


def collector_lanes(params, static):
    """The radiance stage's first update on the collector's scene: its
    2,048 samples' (point, replica) lanes (``collectors._lanes``, bases 0)
    and the experiments a lane."""
    n = records.BATCH_SIZE
    cfg = config.PointRadianceConfig()
    s = collectors.generate_scatter_samples(params, static, n, 0)
    entry = (s.positions + 0.5 * params.bbox_size).contiguous()
    replicas = max(1, cfg.max_threads // collectors.bucket_size(n))
    launches = cfg.launches_per_update
    base = torch.zeros(n, dtype=torch.int64, device=entry.device)
    lanes = collectors._lanes(entry, s.directions.contiguous(),
                              torch.arange(n, device=entry.device), base, replicas, launches)
    return lanes, launches


def k7b_variants(lib, params, static) -> Dict[str, dict]:
    """K7b in each design of K7B_DESIGNS against the package's, at the
    radiance stage's first update on the collector's scene: records and
    folds bitwise."""
    rs = collectors.radiance_static(static)
    lanes, launches = collector_lanes(params, static)
    ref_pm, ref_rec = collectors.launch_radiance(params, rs, *lanes, 0, launches)
    steps = int(ref_pm.steps.sum())
    out: Dict[str, dict] = {}
    fns = {}
    for key, variant in K7B_DESIGNS.items():
        def run(variant=variant):
            lib.ds_radiance_variant(*variant)
            return collectors.launch_radiance(params, rs, *lanes, 0, launches, lib=lib)

        pm, rec = run()
        _, slots, resolves, resolved = (int(v) for v in collectors.radiance_moments.last_counters)
        equal = (all(torch.equal(a, b) for a, b in zip(pm, ref_pm))
                 and all(torch.equal(a, b) for a, b in zip(rec, ref_rec)))
        row = dict(equal=equal, simt_efficiency=steps / (32.0 * slots))
        if resolves:
            row["crossings_per_resolve_step"] = resolved / resolves
        out[key] = row
        fns[key] = run
        del pm, rec
    for key, ms in in_turns(fns, 3).items():
        out[key]["ms"] = ms
        out[key]["steps_per_s"] = steps / (min(ms) * 1e-3)
        print(f"K7b {key}: {json.dumps(out[key])}", flush=True)
    out["work"] = dict(lanes=int(lanes[0].shape[0]), experiments=int(lanes[0].shape[0]) * launches,
                       steps=steps, scatters=int(ref_pm.bounces.sum()))
    return out


@functools.lru_cache(maxsize=2)
def cloud(res: int, seed: int) -> np.ndarray:
    """The normalised procedural cumulus of a diff point."""
    from ..ops import grid as grid_ops

    return grid_ops.normalize_density(procedural.cumulus(resolution=res, seed=seed))


def diff_inputs(diff, res: int, seed: int, sun, eye, kw: dict, dev, baked: bool = True):
    """A diff point's main-path kernel inputs: the march's (through K3
    where ``baked``), the upstream of the image mean a ray, the forward's
    radiance, K8b's adjoint and K8a's inputs (the bake's T, the baked
    grid's gradient; None pointwise)."""
    base = config.SceneConfig()
    density = cloud(res, seed)
    scene = diff.diff_scene_from_numpy(
        density, np.asarray(sun or base.light.direction, np.float32),
        np.asarray(eye or base.camera.eye, np.float32), np.zeros(3, np.float32),
        np.full(3, 1e6, np.float32), device=dev)
    with torch.no_grad():
        m = diff.march_setup(scene, **{**diff_defaults(diff), **kw}, use_baked_inscatter=baked,
                             kernels=True)
        n = m.entry.shape[0]
        args = (scene.density, m.baked, None if m.to_sun is None else m.to_sun.contiguous(),
                m.entry.contiguous(), m.dirs.contiguous(), m.p_phase.contiguous(),
                m.hit.to(torch.uint8), m.meta)
        g_rad = torch.where(m.hit, scene.light_radiance.sum() / (3 * n),
                            torch.zeros((), device=dev)).to(torch.float32).contiguous()
        rad = diff.launch_march(*args)
        back = diff.launch_march_bwd(*args[:7], rad, g_rad, m.meta)
        sun_n = scene.sun_dir / torch.linalg.norm(scene.sun_dir)
    if not baked:
        return args, rad, g_rad, back, None
    meta = m.meta
    trans = inscatter.launch_bake(scene.density, meta.bbox, tuple(sun_n.tolist()), meta.step,
                                  meta.density_multiplier, False)
    adj = (scene.density, meta.bbox, tuple(sun_n.tolist()), meta.density_multiplier, meta.step,
           trans, back.baked.reshape(-1).contiguous())
    return args, rad, g_rad, back, adj


def diff_defaults(diff) -> dict:
    """``render_single_scatter``'s defaults but the scene and device."""
    import inspect

    params = inspect.signature(diff.render_single_scatter).parameters
    return {k: p.default for k, p in params.items()
            if k not in ("scene", "device", "use_baked_inscatter")}


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def diff_lib(lib) -> int:
    """Types ``csrc/diff_variants.cu``'s entry points in ``lib``; returns
    the package's K8a voxels a thread."""
    lib.ds_diff_variant.argtypes = [ctypes.c_int] * 3
    lib.ds_diff_variant.restype = None
    lib.ds_diff_forward_variant.argtypes = [ctypes.c_int] * 3
    lib.ds_diff_forward_variant.restype = None
    for name in ("ds_diff_lanes", "ds_diff_forward_lanes"):
        getattr(lib, name).argtypes = [ctypes.c_int64]
        getattr(lib, name).restype = ctypes.c_int
    return lib_const(lib, "ds_adjoint_voxels")


def package_choice(lib, rays: int) -> dict:
    """The package's choices for ``rays`` rays, by ``variant``'s names."""
    return dict(k8a=lib_const(lib, "ds_adjoint_voxels"), k8b=lib.ds_diff_lanes(rays), scatter=0,
                march=lib.ds_diff_forward_lanes(rays), sun=1, sun_bwd=1)


def variant(lib, rays: int, **choice):
    """A call that sets every alternative of ``csrc/diff_variants.cu``:
    the package's for ``rays`` rays but where ``choice`` names another (K8a
    ``k8a``, K8b's adjoint ``k8b`` and its ``scatter``, K8b's forward
    ``march``, the sun march ``sun`` and ``sun_bwd``)."""
    c = {**package_choice(lib, rays), **choice}

    def apply():
        lib.ds_diff_variant(c["k8a"], c["k8b"], c["scatter"])
        lib.ds_diff_forward_variant(c["march"], c["sun"], c["sun_bwd"])

    return apply


def set_variant(lib, rays: int, **choice) -> None:
    """``variant``'s choice, set now."""
    variant(lib, rays, **choice)()


def k8a_design(lib, adj, design: int, lanes: int, scatter: int = 0, float64: bool = True):
    """K8a in ``design`` (``K8A_DESIGNS``' codes) on the wrapper's
    arguments ``adj``, as a call."""
    from ..render import diff

    choose = variant(lib, 1, k8a=design, k8b=lanes, scatter=scatter)

    def run():
        choose()
        return diff.launch_bake_adjoint(*adj, lib=lib, float64=float64)

    return run


def k8b_design(lib, bwd, voxels: int, lanes: int, scatter: int = 0):
    """K8b's adjoint with ``lanes`` lanes a ray (0: a thread a ray) on the
    wrapper's arguments ``bwd``, as a call."""
    from ..render import diff

    choose = variant(lib, bwd[3].shape[0], k8a=voxels, k8b=lanes, scatter=scatter)

    def run():
        choose()
        return diff.launch_march_bwd(*bwd, lib=lib)

    return run


def forward_design(lib, fwd, march: int, steps=None):
    """K8b's forward with ``march`` lanes a ray (0: a thread a ray) on the
    wrapper's arguments ``fwd``, as a call."""
    from ..render import diff

    choose = variant(lib, fwd[3].shape[0], march=march)

    def run():
        choose()
        return diff.launch_march(*fwd, steps=steps, lib=lib)

    return run


def sun_design(lib, sun_args, lanes: int, adjoint: bool, scatter: int = 0):
    """The sun march (or its adjoint) with ``lanes`` lanes a point (0: its
    first design; 1: the package's thread a point) on the
    wrapper's arguments ``sun_args`` (those of ``launch_sun_march``, or of
    ``launch_sun_march_bwd``; its scatters left out where ``scatter`` is
    2), as a call."""
    from ..render import diff

    choose = variant(lib, sun_args[2].shape[0], scatter=scatter,
                     **{"sun_bwd" if adjoint else "sun": lanes})

    def run():
        choose()
        if adjoint:
            return diff.launch_sun_march_bwd(*sun_args, lib=lib)
        return diff.launch_sun_march(*sun_args, lib=lib)

    return run


def mean(ms: List[float]) -> float:
    return sum(ms) / len(ms)


def pair_in_turns(new, first, reps: int) -> tuple:
    """(new's, first's) mean ms over four turns by ``ahead_ms``."""
    t = in_turns({"new": new, "first": first}, reps, ahead_ms)
    return mean(t["new"]), mean(t["first"])


def against_first(adj, bwd, reps_a: int, reps_b: int) -> dict:
    """K8a and K8b's adjoint, the package's kernels against their first
    designs (a thread a voxel, a thread a ray; ``csrc/diff_variants.cu``)
    on the same inputs in one call: each pair's mean ms over four turns
    by ``ahead_ms``, and each output's largest difference over its largest
    value (K8a's density gradient in float64).  ``adj``, ``bwd``: the
    arguments of ``launch_bake_adjoint`` (None: no K8a, pointwise) and
    ``launch_march_bwd``."""
    from ..render import diff

    lib = cuda_build.load("diff_variants")
    voxels = diff_lib(lib)
    lanes = lib.ds_diff_lanes(bwd[3].shape[0])
    first_b = k8b_design(lib, bwd, voxels, 0)
    out = dict(lanes=lanes, rel_err={})
    if adj is not None:
        out["ms_a"], out["ms_a_first"] = pair_in_turns(
            lambda: diff.launch_bake_adjoint(*adj), k8a_design(lib, adj, 0, lanes, float64=False),
            reps_a)
        out["rel_err"]["K8a density"] = rel_err(diff.launch_bake_adjoint(*adj, float64=True)[0],
                                                k8a_design(lib, adj, 0, lanes)()[0])
    out["ms_b"], out["ms_b_first"] = pair_in_turns(lambda: diff.launch_march_bwd(*bwd), first_b,
                                                   reps_b)
    new_b, old_b = diff.launch_march_bwd(*bwd), first_b()
    out["rel_err"].update({f"K8b {f}": rel_err(getattr(new_b, f), getattr(old_b, f))
                           for f in LEAVES if getattr(old_b, f) is not None})
    return out


def forward_against_first(fwd, reps: int) -> dict:
    """K8b's forward, the package's kernel against its first design (a
    thread a ray) on the same inputs in one call: mean ms over four turns
    by ``ahead_ms``, and whether the radiance and the step counts are
    bitwise equal.  ``fwd``: ``launch_march``'s arguments."""
    from ..render import diff

    lib = cuda_build.load("diff_variants")
    diff_lib(lib)
    n = fwd[3].shape[0]
    steps = [torch.zeros((n, 3), dtype=torch.int32, device=fwd[3].device) for _ in range(2)]
    first = forward_design(lib, fwd, 0)
    ms, ms_first = pair_in_turns(lambda: diff.launch_march(*fwd), first, reps)
    new = diff.launch_march(*fwd, steps=steps[0])
    old = forward_design(lib, fwd, 0, steps=steps[1])()
    return dict(ms=ms, ms_first=ms_first, lanes=lib.ds_diff_forward_lanes(n),
                bitwise=bool(torch.equal(new, old) and torch.equal(steps[0], steps[1])))


def sun_against_first(fwd, bwd, reps: int) -> dict:
    """The sun march and its adjoint, the package's kernels against their
    first designs (a thread a point) on the same inputs in one call: mean
    ms over four turns each by ``ahead_ms``; T and the samples bitwise,
    the adjoint's outputs by their largest difference over their largest.
    ``fwd``, ``bwd``: the arguments of ``launch_sun_march`` and
    ``launch_sun_march_bwd``."""
    from ..render import diff

    lib = cuda_build.load("diff_variants")
    diff_lib(lib)
    ms, ms_first = pair_in_turns(lambda: diff.launch_sun_march(*fwd), sun_design(lib, fwd, 0, False),
                                 reps)
    ms_b, ms_b_first = pair_in_turns(lambda: diff.launch_sun_march_bwd(*bwd),
                                     sun_design(lib, bwd, 0, True), reps)
    n = fwd[2].shape[0]
    steps = [torch.zeros(n, dtype=torch.int32, device=fwd[2].device) for _ in range(2)]
    new = diff.launch_sun_march(*fwd, steps=steps[0])
    old = sun_design(lib, (*fwd, steps[1]), 0, False)()
    new_b, old_b = diff.launch_sun_march_bwd(*bwd), sun_design(lib, bwd, 0, True)()
    return dict(ms=ms, ms_first=ms_first, ms_bwd=ms_b, ms_bwd_first=ms_b_first,
                bitwise=bool(torch.equal(new, old) and torch.equal(steps[0], steps[1])),
                rel_err={k: rel_err(a, b) for k, a, b in zip(("density", "pos", "to_sun"),
                                                             new_b, old_b)})


def forward_sweep(lib, fwd, reps: int) -> Dict[str, dict]:
    """K8b's forward in each design of ``FORWARD_DESIGNS`` on ``fwd``, in
    turns by ``ahead_ms``; each bitwise against the package's kernel."""
    from ..render import diff

    n = fwd[3].shape[0]
    ref = diff.launch_march(*fwd)
    row: Dict[str, dict] = {}
    fns = {}
    for key, g in FORWARD_DESIGNS.items():
        name = f"K8b forward {key}"
        fns[name] = forward_design(lib, fwd, g)
        row[name] = dict(bitwise=bool(torch.equal(fns[name](), ref)))
    for key, ms in in_turns(fns, reps, ahead_ms).items():
        row[key]["ms"] = ms
    set_variant(lib, n)
    return row


def sun_sweep(lib, fwd, bwd, reps: int) -> Dict[str, dict]:
    """The sun march and its adjoint in each design of ``SUN_DESIGNS`` on
    ``fwd`` / ``bwd``, in turns by ``ahead_ms``: T bitwise against the
    package's kernel, the adjoint within 1e-5 of each output's largest."""
    from ..render import diff

    ref, ref_b = diff.launch_sun_march(*fwd), diff.launch_sun_march_bwd(*bwd)
    row: Dict[str, dict] = {}
    fns = {}
    for key, g in SUN_DESIGNS.items():
        fns[f"sun march {key}"] = sun_design(lib, fwd, g, False)
        row[f"sun march {key}"] = dict(bitwise=bool(torch.equal(fns[f"sun march {key}"](), ref)))
    for key, ms in in_turns(fns, reps, ahead_ms).items():
        row[key]["ms"] = ms
    fns = {}
    for key, g in SUN_DESIGNS.items():
        fns[f"sun adjoint {key}"] = sun_design(lib, bwd, g, True)
        errs = [rel_err(a, b) for a, b in zip(fns[f"sun adjoint {key}"](), ref_b)]
        row[f"sun adjoint {key}"] = dict(rel_err=max(errs), equal=max(errs) <= 1e-5)
        if g in (0, 1):  # the split: its scatters left out
            fns[f"sun adjoint {key} no atomics"] = sun_design(lib, bwd, g, True, scatter=2)
            row[f"sun adjoint {key} no atomics"] = {}
    for key, ms in in_turns(fns, reps, ahead_ms).items():
        row[key]["ms"] = ms
    set_variant(lib, 1)
    row["package"] = dict(points=int(fwd[2].shape[0]))
    return row


def sun_inputs(diff, dev, points: int = 0, order: str = "voxel"):
    """The sun march's inputs at chip_smoke.py's: the 262,144 voxel centres
    of the defaults point's 64^3 cloud (if given, the first ``points`` of
    them in ``order`` "voxel", or ``points`` at random) toward its sun, 128
    steps of 1/256, dm 100, the upstream rng(8)'s; (launch_sun_march's,
    launch_sun_march_bwd's arguments)."""
    res, seed, sun, _, _ = DIFF_POINTS["defaults"]
    density = torch.from_numpy(cloud(res, seed)).to(dev).contiguous()
    centres = torch.from_numpy(np.stack(np.meshgrid(
        *(np.arange(n, dtype=np.float32) + 0.5 for n in density.shape), indexing="ij")[::-1], -1)
        .reshape(-1, 3) / np.float32(max(density.shape))).to(dev).contiguous()
    w = torch.from_numpy(np.random.default_rng(8).random(centres.shape[0])
                         .astype(np.float32)).to(dev)
    if points:
        pick = (torch.arange(points) if order == "voxel" else
                torch.from_numpy(np.random.default_rng(14).permutation(centres.shape[0])[:points]))
        centres, w = centres[pick.to(dev)].contiguous(), w[pick.to(dev)].contiguous()
    to_sun = diff._to_sun(torch.tensor(sun, dtype=torch.float32, device=dev)).contiguous()
    fwd = (density, to_sun, centres, *SUN_ARGS)
    trans = diff.launch_sun_march(*fwd)
    return fwd, (density, to_sun, centres, trans, w, *SUN_ARGS)


def diff_variants(lib, dev) -> dict:
    """K8a and K8b's adjoint in each design against the package's, at both
    diff points; the scatter split of K8b's adjoint (the first design and
    the package's) and of K8a's first design; K8b's forward in each design
    at both points and pointwise at the defaults point; K8b's adjoint's and
    forward's lanes a ray at LANE_POINTS; the sun march and its adjoint in
    each design at the 262,144 voxel centres and other counts and orders."""
    from ..render import diff

    voxels = diff_lib(lib)
    out: Dict[str, dict] = {}
    ok = True

    def report(point, row):
        nonlocal ok
        for key, r in row.items():
            print(f"diff {point} {key}: {json.dumps(r)}", flush=True)
            if isinstance(r, dict):
                ok = ok and r.get("equal", True) and r.get("bitwise", True)
        out[point] = row

    def k8b_row(row, fns, key, gl, sc, bwd, back):
        fns[key] = k8b_design(lib, bwd, voxels, gl, sc)
        row[key] = {}
        if not sc:
            got = fns[key]()
            errs = {f: rel_err(getattr(got, f), getattr(back, f)) for f in LEAVES
                    if getattr(back, f) is not None}
            row[key].update(rel_err=errs, equal=all(e <= 1e-5 for e in errs.values()))

    for point, (res, seed, sun, eye, kw) in DIFF_POINTS.items():
        args, rad, g_rad, back, adj = diff_inputs(diff, res, seed, sun, eye, kw, dev)
        bwd = (*args[:7], rad, g_rad, args[7])
        lanes = lib.ds_diff_lanes(args[3].shape[0])  # the package's for these rays
        ref_a = diff.launch_bake_adjoint(*adj, float64=True)
        row: Dict[str, dict] = {}
        fns = {}
        for key, v in K8A_DESIGNS.items():
            fns[f"K8a {key}"] = k8a_design(lib, adj, v, lanes)
            got = fns[f"K8a {key}"]()
            errs = dict(density=rel_err(got[0], ref_a[0]), light_dir=rel_err(got[1], ref_a[1]))
            row[f"K8a {key}"] = dict(rel_err=errs, equal=errs["density"] <= 1e-12
                                     and errs["light_dir"] <= 1e-5)
        for skey, sc in list(SCATTERS.items())[1:]:  # the first design's scatters
            row[f"K8a first design (a thread a voxel) {skey}"] = {}
            fns[f"K8a first design (a thread a voxel) {skey}"] = k8a_design(lib, adj, 0, lanes, sc)
        for key, ms in in_turns(fns, 3 if point == "frame" else 10, ahead_ms).items():
            row[key]["ms"] = ms
        fns = {}
        for key, gl in K8B_DESIGNS.items():
            for skey, sc in SCATTERS.items():
                if sc and gl not in (0, lanes):
                    continue
                k8b_row(row, fns, f"K8b adjoint {key}" + (f" {skey}" if sc else ""), gl, sc, bwd,
                        back)
        for key, ms in in_turns(fns, 5 if point == "frame" else 20, ahead_ms).items():
            row[key]["ms"] = ms
        row.update(forward_sweep(lib, args, 5 if point == "frame" else 20))
        report(point, row)
        del args, rad, g_rad, back, adj, bwd
    res, seed, sun, eye, kw = DIFF_POINTS["defaults"]
    args, rad, g_rad, back, _ = diff_inputs(diff, res, seed, sun, eye, kw, dev, baked=False)
    report("defaults pointwise", forward_sweep(lib, args, 10))
    del args, rad, g_rad, back
    res, seed, sun, eye, kw = DIFF_POINTS["frame"]
    for point, (w, h) in LANE_POINTS.items():
        args, rad, g_rad, back, _ = diff_inputs(diff, res, seed, sun, eye,
                                                dict(kw, width=w, height=h), dev)
        bwd = (*args[:7], rad, g_rad, args[7])
        row = {"package": dict(rays=int(args[3].shape[0]),
                               lanes=lib.ds_diff_lanes(args[3].shape[0]),
                               forward_lanes=lib.ds_diff_forward_lanes(args[3].shape[0]))}
        fns = {}
        for gl in (8, 16, 32):
            k8b_row(row, fns, f"K8b adjoint G={gl}", gl, 0, bwd, back)
        for key, ms in in_turns(fns, 10, ahead_ms).items():
            row[key]["ms"] = ms
        row.update(forward_sweep(lib, args, 10))
        report(point, row)
        del args, rad, g_rad, back, bwd
    for order in SUN_ORDERS:
        for points in SUN_POINTS:
            fwd, bwd = sun_inputs(diff, dev, points, order)
            report(f"sun march ({points} points, {order} order)", sun_sweep(lib, fwd, bwd, 10))
    set_variant(lib, 1)
    out["ok"] = ok
    return out


def ms_frame_inputs(diff, dev):
    """``launch_path_adjoint``'s arguments at the multi-scatter frame point
    but the upstream, and the image mean's upstream (1 / (3 N n_subframes)
    on each record of a pixel that hits)."""
    base = config.SceneConfig()
    scene = diff.diff_scene_from_numpy(
        cloud(256, 11), np.asarray(base.light.direction, np.float32),
        np.asarray(base.camera.eye, np.float32), np.zeros(3, np.float32),
        np.full(3, 1e6, np.float32), device=dev)
    cfg = config.SceneConfig(cloud=config.CloudModel(size_m=2000.0))
    kw = MS_FRAME
    with torch.no_grad():
        params, static = diff.diff_scene(cfg, scene, kw["max_depth"])
        rays = diff.path_rays(scene, cfg, kw["width"], kw["height"], params, static)
    p = diff._sample_params(params.density_mips[0].detach().contiguous(),
                            params.inscatter.detach().contiguous(), params.phase)
    n, s = rays.hit.shape[0], kw["n_subframes"]
    args = (p, static, rays.entry.detach().contiguous(), rays.dirs.detach().contiguous(),
            rays.hit, rays.ids, kw["seed"], 1, s)
    g = torch.where(rays.hit[None, :, None], 1.0 / (3 * n * s), 0.0).to(torch.float32)
    return args, g.expand(s, n, 3).contiguous()


def registers(lib, name: str, *args) -> int:
    """A kernel's registers a thread, by ``cudaFuncGetAttributes`` through
    the library's export ``name``."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_int
    return int(fn(*args))


def path_lib(lib):
    """Types ``csrc/path_adjoint_variants.cu``'s ``ds_path_variant``."""
    lib.ds_path_variant.argtypes = [ctypes.c_int] * 4
    lib.ds_path_variant.restype = None
    return lib


def path_design(lib, args, g, code):
    """A call of K8c's alternative ``code`` (``ds_path_variant``'s
    arguments) on ``launch_path_adjoint``'s arguments ``args`` and the
    upstream ``g``."""
    from ..render import diff

    def run():
        lib.ds_path_variant(*code)
        return diff.launch_path_adjoint(*args, g, lib=lib)
    return run


def path_check(got, ref, rec, hit) -> dict:
    """An alternative's outputs against the package's: the records bitwise
    (and against K4's where the pixels hit), each gradient's largest
    difference over its largest value."""
    same = (torch.equal(got.records.radiance, ref.records.radiance)
            and torch.equal(got.records.work, ref.records.work)
            and torch.equal(got.records.radiance[:, hit], rec.radiance[:, hit])
            and torch.equal(got.records.work[:, hit], rec.work[:, hit]))
    errs = {f: rel_err(getattr(got, f), getattr(ref, f)) for f in PATH_LEAVES}
    return dict(bitwise=same, rel_err=errs,
                equal=same and all(e <= PATH_TOL[f] for f, e in errs.items()))


def path_against_first(args, g, reps: int) -> dict:
    """K8c, the package's two kernels against its first design (a thread an
    item; ``csrc/path_adjoint_variants.cu``), each with the upstream ``g``
    and with a zero upstream (the replay alone), in four turns by
    ``ahead_ms``, in one call: their means, the kernels' registers, the
    work list's length and the sweep's lanes; the first design's records
    bitwise against the package's and its gradients within PATH_TOL.
    ``args``: ``launch_path_adjoint``'s arguments but the upstream."""
    from ..render import diff

    lib, pkg = path_lib(cuda_build.load("path_adjoint_variants")), cuda_build.load("path_adjoint")
    zero = torch.zeros_like(g)
    first = PATH_DESIGNS["first design (a thread an item)"]
    counters = torch.zeros(4, dtype=torch.int64, device=g.device)
    fns = {"new": lambda: diff.launch_path_adjoint(*args, g),
           "first": path_design(lib, args, g, first),
           "new replay": lambda: diff.launch_path_adjoint(*args, zero),
           "first replay": path_design(lib, args, zero, first)}
    t = {k: mean(v) for k, v in in_turns(fns, reps, ahead_ms).items()}
    ref = diff.launch_path_adjoint(*args, g, counters=counters)
    length = int(counters[1]) + int(counters[3])
    rec = pathtracer.launch_samples(*args)
    check = path_check(fns["first"](), ref, rec, args[4])
    return dict(ms=t["new"], ms_first=t["first"], ms_replay=t["new replay"],
                ms_first_replay=t["first replay"], lanes=lib_const(pkg, "ds_path_lanes"),
                work_list=length, registers=dict(
                    replay=registers(pkg, "ds_path_registers", 0),
                    sweep=registers(pkg, "ds_path_registers", 1),
                    first=registers(lib, "ds_path_registers", 2)), **check)


def path_timeline(lib, args, g) -> dict:
    """The package's sweep timed entry by entry (``ds_path_variant``'s sweep
    code 200, the card's global timer): when the entries end (quantiles of
    the kernel's span), how long they take against the steps they
    re-march, and the longest ones.  One launch (the frame's pixels fit
    the scratch budget), so a list entry's item is its launch item."""
    from ..render import diff

    n_sub, n = g.shape[:2]
    timeline = torch.zeros(4 * n_sub * n, dtype=torch.int64, device=g.device)
    remarch = torch.zeros((n_sub, n), dtype=torch.int32, device=g.device)
    lib.ds_path_timeline.argtypes = [ctypes.c_void_p]
    lib.ds_path_timeline.restype = None
    lib.ds_path_timeline(cuda_build.ptr(timeline))
    counters = torch.zeros(4, dtype=torch.int64, device=g.device)
    lib.ds_path_variant(1, lib_const(cuda_build.load("path_adjoint"), "ds_path_lanes"), -1, 200)
    diff.launch_path_adjoint(*args, g, remarch=remarch, counters=counters, lib=lib)
    counters = counters.cpu()
    t = timeline.view(-1, 4)[:int(counters[1] + counters[3])].cpu()
    start = t[:, 0] - t[:, 0].min()
    end = t[:, 1] - t[:, 0].min()
    dur = (end - start).double()
    steps = remarch.view(-1).cpu()[t[:, 2] >> 32].double()
    q = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=torch.float64)
    longest = torch.argsort(dur, descending=True)[:8]
    heavy = steps >= 256
    return dict(
        entries=int(t.shape[0]), span_us=float(end.max()) / 1e3,
        end_us_at_quantiles=[round(float(v) / 1e3, 1) for v in torch.quantile(end.double(), q)],
        duration_us_at_quantiles=[round(float(v) / 1e3, 2) for v in torch.quantile(dur, q)],
        remarched_steps_at_quantiles=[float(v) for v in torch.quantile(steps, q)],
        ns_per_step_long=(float(dur[heavy].sum() / steps[heavy].sum())
                          if bool(heavy.any()) else None),
        ns_per_sample_short=float(dur[steps < 64].mean()),
        busy_us_total=float(dur.sum()) / 1e3,
        longest=[dict(us=round(float(dur[k]) / 1e3, 1), steps=int(steps[k]),
                      start_us=round(float(start[k]) / 1e3, 1)) for k in longest])


def path_variants(dev) -> dict:
    """K8c at the multi-scatter frame point in each design of
    ``PATH_DESIGNS``, with the image mean's upstream and with a zero
    upstream (the replay alone), beside the package's kernels and K4 on
    the same samples, in turns by ``ahead_ms``; each design's registers and
    its outputs against the package's."""
    from ..render import diff

    args, g = ms_frame_inputs(diff, dev)
    zero = torch.zeros_like(g)
    lib, pkg = path_lib(cuda_build.load("path_adjoint_variants")), cuda_build.load("path_adjoint")
    counters = torch.zeros(4, dtype=torch.int64, device=dev)
    ref = diff.launch_path_adjoint(*args, g, counters=counters)
    rec = pathtracer.launch_samples(*args)
    out: Dict[str, dict] = {"package": dict(
        lanes=lib_const(pkg, "ds_path_lanes"),
        work_list=int(counters[[1, 3]].sum()),
        registers=dict(replay=registers(pkg, "ds_path_registers", 0),
                       sweep=registers(pkg, "ds_path_registers", 1)))}
    fns = {"package": lambda: diff.launch_path_adjoint(*args, g),
           "package g=0": lambda: diff.launch_path_adjoint(*args, zero),
           "K4": lambda: pathtracer.launch_samples(*args)}
    for key, code in PATH_DESIGNS.items():
        fns[key] = path_design(lib, args, g, code)
        fns[f"{key} g=0"] = path_design(lib, args, zero, code)
        row = path_check(fns[key](), ref, rec, args[4])
        if code[3] > 100:  # the scatters aimed elsewhere: only the records compare
            row["equal"] = row["bitwise"]
        lib.ds_path_variant(*code)
        row["registers"] = {k: registers(lib, "ds_path_registers", c)
                            for k, c in (("replay", 0), ("sweep", 1), ("first", 2))}
        out[key] = row
    out["pathtrace_items_kernel registers"] = registers(cuda_build.load("pathtrace"),
                                                        "ds_pathtrace_registers")
    out["sweep timeline"] = path_timeline(lib, args, g)
    for key, ms in in_turns(fns, 3, ahead_ms).items():
        out.setdefault(key, {})["ms"] = ms
    ok = True
    for key, r in out.items():
        print(f"path {key}: {json.dumps(r)}", flush=True)
        if isinstance(r, dict):
            ok = ok and r.get("equal", True)
    out["ok"] = ok
    return out


#: K9's alternatives (``csrc/spatial_variants.cu``, ``ds_spatial_variant``'s
#: codes: the design (0 the first; 1 the package's kernel; 2 it scanning
#: the rays in order at every G), the lanes a ray (0 the package's choice
#: from the alive count), the launch bounds' resident blocks a SM (0 the
#: threads alone; 1 the package's; 12), the chunks a group marches between
#: refills (0 the package's: 16 lookahead chunks at one lane a ray, else 4)).
SPATIAL_DESIGNS = {"first design (a thread a ray)": (0, 0, 1, 0),
                   "queue, the package's lanes": (1, 0, 1, 0),
                   "queue, the package's lanes, scan in order": (2, 0, 1, 0),
                   **{f"G={g}": (1, g, 1, 0) for g in (1, 4, 8, 16, 32)},
                   **{f"G={g} blocks={b}": (1, g, b, 0) for g in (1, 8, 32) for b in (0, 12)},
                   **{f"G=1 chunks={c}": (1, 1, 1, c) for c in (1, 4, 8, 32)},
                   **{f"G={g} chunks=1": (1, g, 1, 1) for g in (8, 16, 32)}}
#: K9's frames: the PT cell's 512^2 and four times its rays.
SPATIAL_SIZES = (SIZE, 2 * SIZE)


def spatial_lib(lib):
    """Types ``csrc/spatial_variants.cu``'s ``ds_spatial_variant``."""
    lib.ds_spatial_variant.argtypes = [ctypes.c_int] * 4
    lib.ds_spatial_variant.restype = None
    return lib


def spatial_replay(scene, static, seed: int, ids, entry, dirs, hit) -> dict:
    """A subframe's phases on one slab (``merge_slabs``), each phase's
    inputs kept → the cell: the slab scene, the phase static, the seed,
    ray ids, steps a phase, each phase's input records, alive count, the
    package's output records and its counters (rays scanned, warp march
    iterations)."""
    from ..parallel import spatial_render as sr

    st = sr.phase_static(static)
    spp = sr.default_steps_per_phase(static, static.grid_shape[0])
    cell = dict(scene=scene, static=st, seed=seed, ids=ids, spp=spp, recs=[], alive=[], outs=[],
                counters=[])

    def phase(rec, n_alive):
        cell["recs"].append(rec)
        cell["alive"].append(n_alive)
        cell["outs"].append(sr.spatial_phase(scene, st, seed, ids, spp, rec, n_alive))
        cell["counters"].append(sr.spatial_phase.last_counters.tolist() if rec.is_cuda
                                else [0, 0])
        return sr.merge_slabs([cell["outs"][-1]])

    sr.run_phases(sr.begin_records(entry, dirs, hit, scene.bbox_size), phase, spp,
                  static.max_total_steps)
    return cell


def spatial_cell(dev, size: int = SIZE) -> dict:
    """chip_smoke.py's PT cell at world 1 (the 256^3 cumulus of seed 11 at
    2000 m, uint8, ``size``^2 (512^2), all-scatter, ``max_depth`` 2000, one
    slab of 512 steps a phase, seed 5's first subframe) replayed
    (``spatial_replay``), with K4's arguments for the same samples."""
    from ..ops import rng as rng_ops
    from ..parallel import spatial_render as sr

    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=size, height=size),
        rendering=config.CloudRendering(march_dtype="uint8"),
    )
    params, static = build_scene(cfg, procedural.cumulus(resolution=256, seed=11), device=dev)
    params = with_baked_inscatter(params, static, device=dev)
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), size, size, dev)
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    ids = torch.arange(o.shape[0], device=dev)
    seed = rng_ops.subframe_seed(5, 1)
    cell = spatial_replay(sr.slab_scene(params, 0, 1, device=dev), static, seed, ids, entry, d,
                          hit)
    cell["k4"] = (params, static, entry, d, hit, ids, seed, 0, 1)
    return cell


def spatial_design(lib, cell, code):
    """Phase i of the cell through K9's alternative ``code``
    (``ds_spatial_variant``'s arguments): fn(i) → records."""
    from ..parallel import spatial_render as sr

    def run(i):
        lib.ds_spatial_variant(*code)
        return sr._launch(cell["scene"], cell["static"], cell["seed"], cell["ids"], cell["spp"],
                          cell["recs"][i], cell["alive"][i], lib=lib)
    return run


def spatial_against_first(cell, reps: int) -> dict:
    """K9, the package's kernel against its first design on the cell's
    replayed phases, in four turns by ``ahead_ms`` (a subframe's launches
    back to back, then each phase alone): their means, the package's lanes
    a ray each phase, the registers; the first design's records bitwise
    against the package's at every phase."""
    from ..parallel import spatial_render as sr

    lib = spatial_lib(cuda_build.load("spatial_variants"))
    pkg = cuda_build.load("spatial")
    first = spatial_design(lib, cell, SPATIAL_DESIGNS["first design (a thread a ray)"])
    new = [functools.partial(sr.spatial_phase, cell["scene"], cell["static"], cell["seed"],
                             cell["ids"], cell["spp"], r, a)
           for r, a in zip(cell["recs"], cell["alive"])]
    phases = range(len(cell["recs"]))
    fns = {"new": lambda: [f() for f in new], "first": lambda: [first(i) for i in phases]}
    for i in phases:
        fns[f"new {i}"] = new[i]
        fns[f"first {i}"] = functools.partial(first, i)
    t = {k: mean(v) for k, v in in_turns(fns, reps, ahead_ms).items()}
    bitwise = all(torch.equal(first(i), cell["outs"][i]) for i in phases)
    lanes = pkg.ds_spatial_lanes
    lanes.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lanes.restype = ctypes.c_int
    g = [int(lanes(cell["ids"].shape[0], a)) for a in cell["alive"]]
    return dict(ms=t["new"], ms_first=t["first"], phase_ms=[t[f"new {i}"] for i in phases],
                phase_ms_first=[t[f"first {i}"] for i in phases], lanes=g, bitwise=bitwise,
                registers=dict(package={f"G={x}": registers(pkg, "ds_spatial_registers", x)
                                        for x in sorted(set(g))},
                               first=registers(lib, "ds_spatial_registers", 0, 0, 1)))


def spatial_variants(dev) -> dict:
    """K9 at the PT cell's subframe, and at 1024^2 (four times its rays),
    in each design of ``SPATIAL_DESIGNS``, each phase timed alone in turns
    by ``ahead_ms``, beside K4 on the same samples; each design's records
    bitwise against the package's at every phase, and its registers."""
    from ..parallel import spatial_render as sr

    lib = spatial_lib(cuda_build.load("spatial_variants"))
    report = {}
    for size in SPATIAL_SIZES:
        cell = spatial_cell(dev, size)
        out: Dict[str, dict] = {}
        for i, (a, ref) in enumerate(zip(cell["alive"], cell["outs"])):
            steps = ref[:, sr.STEPS]
            print(f"K9 {size}^2 phase {i}: alive={a} steps={int(steps.sum())} "
                  f"longest={int(steps.max())}", flush=True)
        fns = {}
        for key, code in SPATIAL_DESIGNS.items():
            run = spatial_design(lib, cell, code)
            equal = all(torch.equal(run(i), ref) for i, ref in enumerate(cell["outs"]))
            out[key] = dict(equal=equal,
                            registers=registers(lib, "ds_spatial_registers", *code[:3]))
            for i in range(len(cell["recs"])):
                fns[(key, i)] = functools.partial(run, i)
        times = in_turns(fns, 5, ahead_ms)
        for key in SPATIAL_DESIGNS:
            out[key]["phase_ms"] = [mean(times[(key, i)]) for i in range(len(cell["recs"]))]
            out[key]["ms"] = sum(out[key]["phase_ms"])
            print(f"K9 {size}^2 {key}: {json.dumps(out[key])}", flush=True)
        k4 = mean(in_turns({"K4": lambda: pathtracer.scatter_loop(*cell["k4"])}, 5)["K4"])
        print(f"K9 {size}^2 cell: K4 for the same samples ms={k4:.4f}", flush=True)
        report[f"{size}^2"] = dict(designs=out, alive=cell["alive"], k4_ms=k4)
        del cell
    report["ok"] = all(r["equal"] for c in report.values() for r in c["designs"].values())
    return report


#: The cell jump's designs of K4 and K7b (``csrc/pathtrace_variants.cu``,
#: ``ds_jump_variant``'s codes) by name: the first (a jump ends its
#: lookahead chunk; ``cell_exit_steps``' ten divisions), the package's (the
#: jump inside the chunk; the faces by product where every cell count is a
#: power of two, else from a face table in shared memory), the probe (the
#: first design's exits taken and discarded: the kernel without a skip plus
#: the exit arithmetic), the jump inside the chunk with the first design's
#: divided exits, with the face table on every grid, and with each axis's
#: faces chosen at run time in one kernel for every grid.  On a grid whose
#: cell counts are not all powers of two code 1 runs code 5's kernel.
JUMP_DESIGNS = {"first design": 0, "package": 1, "probe (exits discarded)": 2,
                "in-chunk jump, divided exits": 3, "in-chunk jump, face table on every axis": 5,
                "in-chunk jump, faces chosen a launch at run time": 6}
#: The first design counting its jumps.
JUMP_COUNTED = 4
#: chip_smoke.py's PT cell sizes for the jump (its skip phase's).
JUMP_RES = (256, 64)


def jump_lib(lib):
    """Types ``csrc/pathtrace_variants.cu``'s entry points."""
    lib.ds_jump_variant.argtypes = [ctypes.c_int]
    lib.ds_jump_variant.restype = None
    lib.ds_jump_attributes.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.ds_jump_attributes.restype = ctypes.c_int
    lib.ds_jump_count.argtypes = []
    lib.ds_jump_count.restype = ctypes.c_ulonglong
    return lib


def jump_attributes(lib, design: int, radiance: bool, is_u8: bool) -> dict:
    """Registers, local bytes (spills) and resident blocks a SM of a
    design's K4 (``radiance`` false) or K7b kernel."""
    out = (ctypes.c_int * 3)()
    cuda_build.check(lib.ds_jump_attributes(design, int(radiance), int(is_u8), out),
                     "ds_jump_attributes")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2])


def pt_jump_cell(dev, res: int) -> dict:
    """chip_smoke.py's PT cell at ``res``^3 (the cumulus of seed 11 at 2000
    m, uint8, 512^2, a tick's 2 subframes, seed 5) with K4's launch: the
    scene, its static without a skip and with the cell jump alone, and
    ``run(static, lib)`` → (PixelMoments, SampleRecords, counters)."""
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=SIZE, height=SIZE),
        rendering=config.CloudRendering(march_dtype="uint8"),
    )
    params, static = build_scene(cfg, procedural.cumulus(resolution=res, seed=11), device=dev)
    params = with_baked_inscatter(params, static, device=dev)
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), SIZE, SIZE, dev)
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    default = dataclasses.replace(static, occupancy_skip_steps=0, march_empty_skip=False)
    return k4_jump_cell(params, default, entry, d, hit, torch.arange(o.shape[0], device=dev), 5,
                        1, SUBFRAMES)


def k4_jump_cell(params, default, entry, dirs, hit, ids, seed: int, sub_first: int,
                 n_samples: int) -> dict:
    """K4's launch on the given samples as ``jump_compare`` takes it: the
    scene, its static without a skip (``default``) and with the cell jump
    alone, ``run(static, lib)`` → (PixelMoments, SampleRecords, counters)
    and the texel type."""
    def run(st, lib=None):
        return pathtracer.launch_entry(lib, "ds_pathtrace", pathtracer._ARGTYPES, sub_first,
                                       params, st, entry, dirs, hit, ids, seed, n_samples, None,
                                       march.skip_mode(st))
    return dict(params=params, default=default,
                cell=dataclasses.replace(default, march_empty_skip=True), run=run,
                uint8=params.density_mips[0].dtype == torch.uint8, hit=hit.to(torch.bool))


def k7b_jump_cell(dev) -> dict:
    """The collector's first radiance update (``k7b_variants``' lanes: 2,048
    points x 10 replicas, 100 experiments a lane, bases 0) with K7b's
    launch, as ``pt_jump_cell`` gives K4's."""
    params, static = collector_scene(dev, bake=True)
    default = collectors.radiance_static(
        dataclasses.replace(static, occupancy_skip_steps=0, march_empty_skip=False))
    lanes, launches = collector_lanes(params, default)
    return k7b_lanes_cell(params, default, lanes, 0, launches)


def k7b_lanes_cell(params, default, lanes, seed: int, launches: int) -> dict:
    """K7b's launch on the collector's lanes (``collectors._lanes``: entries,
    directions, ids, experiment bases) as ``k4_jump_cell`` gives K4's;
    ``default`` is the radiance static without a skip."""
    def run(st, lib=None):
        pm, rec = collectors.launch_radiance(params, st, *lanes, seed, launches, lib=lib)
        return pm, rec, collectors.radiance_moments.last_counters
    return dict(params=params, default=default,
                cell=dataclasses.replace(default, march_empty_skip=True), run=run,
                uint8=params.density_mips[0].dtype == torch.uint8,
                hit=torch.ones(lanes[0].shape[0], dtype=torch.bool, device=lanes[0].device))


def jump_kernel(code: int, params) -> int:
    """The ``ds_jump_attributes`` design of ``code``'s kernel on the scene:
    the package's on a grid whose cell counts are not all powers of two is
    its kSkipCell instantiation (design 5's), else kSkipCellPow2."""
    pow2 = all(n & (n - 1) == 0 for n in params.density_mips[0].shape)
    table = JUMP_DESIGNS["in-chunk jump, face table on every axis"]
    return table if code == 1 and not pow2 else code


def _same(a, b, skip=(), rows=None) -> bool:
    """Fields of two NamedTuples of tensors bitwise equal, but ``skip``'s;
    of records ([samples, N, ...]) only the pixels ``rows`` (a box hit: the
    others are left unwritten)."""
    pick = (lambda t: t) if rows is None else (lambda t: t[:, rows])
    return all(torch.equal(pick(x), pick(y)) for f, x, y in zip(a._fields, a, b)
               if f not in skip)


def jump_compare(lib, cell: dict, designs: Dict[str, int], reps: int, radiance: bool) -> dict:
    """The cell jump's ``designs`` (``JUMP_DESIGNS``' codes) on a cell of
    ``pt_jump_cell`` or ``k7b_jump_cell``, beside the kernel without a skip
    ("default"), in four turns by ``ahead_ms``: each one's mean ms and turns,
    steps sampled and jumped, warp march iterations (march slots over the
    lookahead), SIMT efficiency of its march (steps sampled over 32 lanes x
    slots; also lattice steps advanced a lane slot), registers, spills and
    resident blocks; the jumps the first design takes (``JUMP_COUNTED``)
    and the mean lattice steps a jump.  Designs 0, 1 and 3 bitwise each
    other (records and folds, jumps included); the probe's records and
    folds bitwise the default's (its jumped count is the exits it
    discarded)."""
    run, k = cell["run"], lib_const(lib, "ds_jump_lookahead")
    ref = run(cell["default"])
    fns = {"default": lambda: run(cell["default"])}
    out: Dict[str, dict] = {"default": dict(steps=int(ref[0].steps.sum()))}
    lib.ds_jump_variant(1)
    pkg = run(cell["cell"], lib)
    for name, code in designs.items():
        def go(code=code):
            lib.ds_jump_variant(code)
            return run(cell["cell"], lib)
        pm, rec, counters = go()
        slots = int(counters[1])
        steps, jumped = int(pm.steps.sum()), int(pm.jumped.sum())
        if code == JUMP_DESIGNS["probe (exits discarded)"]:
            equal = _same(pm, ref[0], ("jumped",)) and _same(rec, ref[1], rows=cell["hit"])
        else:
            equal = _same(pm, pkg[0]) and _same(rec, pkg[1], rows=cell["hit"])
        out[name] = dict(code=code, equal=equal, steps=steps, jumped=jumped,
                         warp_iterations=slots // k, march_slots=slots,
                         simt_efficiency=steps / (32.0 * slots),
                         lattice_steps_per_lane_slot=(steps + jumped) / (32.0 * slots),
                         **jump_attributes(lib, jump_kernel(code, cell["params"]), radiance,
                                           cell["uint8"]))
        fns[name] = go
        del pm, rec
    out["default"].update(march_slots=int(ref[2][1]),
                          simt_efficiency=out["default"]["steps"] / (32.0 * int(ref[2][1])))
    lib.ds_jump_variant(JUMP_COUNTED)
    pm, _, _ = run(cell["cell"], lib)
    torch.cuda.synchronize()
    jumps = int(lib.ds_jump_count())
    lib.ds_jump_variant(1)
    out["jumps"] = jumps
    out["lattice_steps_per_jump"] = int(pm.jumped.sum()) / max(jumps, 1)
    times = in_turns(fns, reps, ahead_ms)
    for name, ms in times.items():
        out[name].update(ms=mean(ms), turns=ms)
    lib.ds_jump_variant(1)
    return out


def jump_variants(dev) -> dict:
    """K4's cell jump in each design of ``JUMP_DESIGNS`` at the PT cell's
    256^3 and 64^3 and K7b's at the collector's first update
    (``jump_compare``, 5 and 3 calls a turn)."""
    lib = jump_lib(cuda_build.load("pathtrace_variants"))
    report = {}
    for res in JUMP_RES:
        r = jump_compare(lib, pt_jump_cell(dev, res), JUMP_DESIGNS, 5, radiance=False)
        report[f"K4 {res}^3"] = r
    report["K7b update"] = jump_compare(lib, k7b_jump_cell(dev), JUMP_DESIGNS, 3, radiance=True)
    for key, r in report.items():
        for name, row in r.items():
            print(f"jump {key} {name}: {json.dumps(row)}", flush=True)
    report["ok"] = all(row["equal"] for r in report.values() for k, row in r.items()
                       if isinstance(row, dict) and "equal" in row)
    return report


#: K4's block-skip designs (``csrc/pathtrace_variants.cu``'s
#: ``ds_block_variant`` codes), both with the same values: the first (the
#: float32 occupancy read at every step) and the package's (the density
#: certificate, the occupancy's bits).
BLOCK_DESIGNS = {"first design": 0, "package": 1}
#: K7a's cell-jump designs (``csrc/march_variants.cu``'s
#: ``ds_cell_samples_variant`` codes), both with the same values: the first
#: (8 warps a sample, each attempt in chunks of 32 lanes ended after the
#: first lane in an empty cell) and the package's (a thread an attempt, 32
#: a round, lookahead 4).
CELL_SAMPLE_DESIGNS = {"first design": 0, "package": 1}


def block_lib(lib):
    """Types ``csrc/pathtrace_variants.cu``'s entry points, the block
    skip's with the cell jump's."""
    jump_lib(lib)
    lib.ds_block_variant.argtypes = [ctypes.c_int]
    lib.ds_block_variant.restype = None
    lib.ds_block_attributes.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.ds_block_attributes.restype = ctypes.c_int
    return lib


def block_attributes(lib, design: int, is_u8: bool) -> dict:
    """Registers, local bytes (spills) and resident blocks a SM of a
    block-skip design's kernel."""
    out = (ctypes.c_int * 3)()
    cuda_build.check(lib.ds_block_attributes(design, int(is_u8), out),
                     "ds_block_attributes")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2])


def k4_block_cell(params, default, block, entry, dirs, hit, ids, seed: int, sub_first: int,
                  n_samples: int) -> dict:
    """K4's launch on the given samples as ``block_compare`` takes it: the
    scene, its static without a skip (``default``) and with the block skip
    (``block``), ``run(static, lib)`` → (PixelMoments, SampleRecords,
    counters) and the texel type."""
    def run(st, lib=None):
        return pathtracer.launch_entry(lib, "ds_pathtrace", pathtracer._ARGTYPES, sub_first,
                                       params, st, entry, dirs, hit, ids, seed, n_samples, None,
                                       march.skip_mode(st))
    return dict(params=params, default=default, block=block, run=run,
                uint8=params.density_mips[0].dtype == torch.uint8, hit=hit.to(torch.bool))


def pt_block_cell(dev, res: int) -> dict:
    """chip_smoke.py's PT cell at ``res``^3 with its occupancy built (as
    ``pt_jump_cell``) for ``block_compare``."""
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=SIZE, height=SIZE),
        rendering=config.CloudRendering(march_dtype="uint8", occupancy_skipping=True),
    )
    params, static = build_scene(cfg, procedural.cumulus(resolution=res, seed=11), device=dev)
    params = with_baked_inscatter(params, static, device=dev)
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), SIZE, SIZE, dev)
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    default = dataclasses.replace(static, occupancy_skip_steps=0, march_empty_skip=False)
    return k4_block_cell(params, default, static, entry, d, hit,
                         torch.arange(o.shape[0], device=dev), 5, 1, SUBFRAMES)


def block_compare(lib, cell: dict, designs: Dict[str, int], reps: int) -> dict:
    """K4's block-skip ``designs`` (``BLOCK_DESIGNS``' codes) on a cell of
    ``k4_block_cell``, beside the kernel without a skip ("default"), in
    four turns by ``ahead_ms``: each one's mean ms and turns, steps sampled
    and jumped, warp march iterations, SIMT efficiency of its march (steps
    sampled over 32 lanes x slots), registers, spills and resident blocks;
    every design bitwise the package's (records and folds, jumps
    included)."""
    run, k = cell["run"], lib_const(lib, "ds_jump_lookahead")
    ref = run(cell["default"])
    fns = {"default": lambda: run(cell["default"])}
    slots = int(ref[2][1])
    out: Dict[str, dict] = {"default": dict(steps=int(ref[0].steps.sum()), march_slots=slots,
                                            warp_iterations=slots // k)}
    out["default"]["simt_efficiency"] = out["default"]["steps"] / (32.0 * slots)
    lib.ds_block_variant(1)
    pkg = run(cell["block"], lib)
    for name, code in designs.items():
        def go(code=code):
            lib.ds_block_variant(code)
            return run(cell["block"], lib)
        pm, rec, counters = go()
        slots = int(counters[1])
        steps, jumped = int(pm.steps.sum()), int(pm.jumped.sum())
        out[name] = dict(code=code, equal=_same(pm, pkg[0]) and _same(rec, pkg[1],
                                                                      rows=cell["hit"]),
                         steps=steps, jumped=jumped, warp_iterations=slots // k, march_slots=slots,
                         simt_efficiency=steps / (32.0 * slots),
                         **block_attributes(lib, code, cell["uint8"]))
        fns[name] = go
        del pm, rec
    times = in_turns(fns, reps, ahead_ms)
    for name, ms in times.items():
        out[name].update(ms=mean(ms), turns=ms)
    lib.ds_block_variant(1)
    return out


def cell_samples_lib(lib):
    """Types ``csrc/march_variants.cu``'s K7a cell-jump choice."""
    lib.ds_cell_samples_variant.argtypes = [ctypes.c_int]
    lib.ds_cell_samples_variant.restype = None
    return lib


def samples_compare(lib, params, default, cell, n: int, seed: int, designs: Dict[str, int],
                    reps: int) -> dict:
    """K7a's cell-jump ``designs`` (``CELL_SAMPLE_DESIGNS``' codes, from
    ``lib``, ``csrc/march_variants.cu``) on ``n`` samples of the scene,
    beside the package's own library with the jump ("package library") and
    without a skip ("default"), in four turns by ``ahead_ms``: each one's
    mean ms and turns, steps and attempts; every design bitwise the
    package's (every field)."""
    pkg = collectors._launch_samples(params, cell, n, seed)
    ref = collectors._launch_samples(params, default, n, seed)
    fns = {"package library": lambda: collectors._launch_samples(params, cell, n, seed),
           "default": lambda: collectors._launch_samples(params, default, n, seed)}
    out: Dict[str, dict] = {
        "package library": dict(steps=int(pkg.steps.sum()), attempts=int(pkg.attempts.sum()),
                                attempts_max=int(pkg.attempts.max())),
        "default": dict(steps=int(ref.steps.sum()), attempts=int(ref.attempts.sum()))}
    for name, code in designs.items():
        def go(code=code):
            lib.ds_cell_samples_variant(code)
            return collectors._launch_samples(params, cell, n, seed, lib=lib)
        got = go()
        out[name] = dict(code=code, equal=_same(got, pkg), steps=int(got.steps.sum()))
        fns[name] = go
        del got
    times = in_turns(fns, reps, ahead_ms)
    for name, ms in times.items():
        out[name].update(ms=mean(ms), turns=ms)
    lib.ds_cell_samples_variant(1)
    return out


def skip_variants(dev) -> dict:
    """K4's block skip in each design of ``BLOCK_DESIGNS`` at the PT
    cell's 256^3 and 64^3 (``block_compare``, 5 calls a turn) and K7a's
    cell jump in each of ``CELL_SAMPLE_DESIGNS`` on the collector's scene
    and 2,048 samples (``samples_compare``, 20 calls a turn)."""
    lib = block_lib(cuda_build.load("pathtrace_variants"))
    report = {}
    for res in JUMP_RES:
        report[f"K4 block {res}^3"] = block_compare(lib, pt_block_cell(dev, res), BLOCK_DESIGNS,
                                                    5)
    params, static = collector_scene(dev, bake=False)
    default = dataclasses.replace(static, occupancy_skip_steps=0, march_empty_skip=False)
    report["K7a cell jump"] = samples_compare(
        cell_samples_lib(cuda_build.load("march_variants")), params, default,
        dataclasses.replace(default, march_empty_skip=True), records.BATCH_SIZE, 0,
        CELL_SAMPLE_DESIGNS, 20)
    for key, r in report.items():
        for name, row in r.items():
            print(f"skip {key} {name}: {json.dumps(row)}", flush=True)
    report["ok"] = all(row["equal"] for r in report.values() for row in r.values()
                       if isinstance(row, dict) and "equal" in row)
    return report


def lib_const(lib, name: str) -> int:
    """An int a library's entry point ``name()`` returns."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    return int(fn())


def render_variants(lib, dev) -> dict:
    """K4, K3, K1 and K2's alternatives on the path tracer's and the neural
    frame's operating points."""
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=SIZE, height=SIZE),
        rendering=config.CloudRendering(march_dtype="uint8"),
    )
    params, static = build_scene(cfg, procedural.cumulus(resolution=256, seed=11), device=dev)
    params = with_baked_inscatter(params, static, device=dev)
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), SIZE, SIZE, dev)
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    args = (entry, d, hit, torch.arange(o.shape[0], device=dev), 5, 1, SUBFRAMES, None)

    ref = pathtracer._launch(params, static, *args)
    steps = int(ref.steps.sum().item())
    k4: Dict[str, dict] = {}
    k4_fns = {}
    for pixel, lookaheads in ((0, QUEUE_LOOKAHEADS), (1, PIXEL_LOOKAHEADS)):
        for k in lookaheads:
            key = f"{'pixel' if pixel else 'queue'} K={k}"

            def run(pixel=pixel, k=k):
                lib.ds_variant(pixel, k, 0)  # (K3's choice unused here)
                return pathtracer._launch(params, static, *args, lib=lib)

            got = run()
            equal = all(torch.equal(a, b) for a, b in zip(got, ref))
            if pixel:
                simt = simt_per_pixel(got.steps)
            else:
                simt = steps / (32.0 * int(pathtracer.scatter_loop.last_counters[1].item()))
            k4[key] = dict(equal=equal, simt_efficiency=simt)
            k4_fns[key] = run
    for key, ms in in_turns(k4_fns, 20).items():
        k4[key]["ms"] = ms
        print(f"K4 {key}: {json.dumps(k4[key])}", flush=True)

    k3_args = (params.density_mips[0], static.bbox, static.light_direction, static.sample_step,
               static.density_multiplier, True)
    ref3 = inscatter.launch_bake(*k3_args)
    k3: Dict[str, dict] = {}
    k3_fns = {}
    for v in VOXELS:
        def bake(v=v):
            lib.ds_variant(0, 0, v)  # (K4's choice unused here)
            return inscatter.launch_bake(*k3_args, lib=lib)

        k3[f"V={v}"] = dict(equal=torch.equal(bake(), ref3))
        k3_fns[f"V={v}"] = bake
    for key, ms in in_turns(k3_fns, 3).items():
        k3[key]["ms"] = ms
        print(f"K3 {key}: {json.dumps(k3[key])}", flush=True)

    pass1, pass2, points = neural_inputs(params, static, dev)
    print(f"neural frame: pass1_rays={pass1[0].shape[0]} pass2_rays={pass2[0].shape[0]} "
          f"points={points[0].shape[0]}", flush=True)
    k1 = k1_variants(lib, params, static, pass1, pass2)
    k2 = k2_variants(lib, params, static, points)
    ok = all(r["equal"] for r in list(k4.values()) + list(k3.values()) + list(k2.values()))
    ok = ok and all(r["equal"] for k, r in k1.items() if k != "steps")
    return dict(steps=steps, K4=k4, K3=k3, K1=k1, K2=k2, ok=ok)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--collector-only", action="store_true",
                      help="time only K7a's and K7b's alternatives")
    only.add_argument("--diff-only", action="store_true",
                      help="time only the diff kernels' alternatives (K8a, K8b, K8c)")
    only.add_argument("--path-only", action="store_true",
                      help="time only K8c's designs (the path adjoint)")
    only.add_argument("--spatial-only", action="store_true",
                      help="time only K9's designs (the slab march)")
    only.add_argument("--jump-only", action="store_true",
                      help="time only the cell jump's designs (K4, K7b)")
    only.add_argument("--skip-only", action="store_true",
                      help="time only K4's block-skip and K7a's cell-jump designs")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("march_variants: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    t0 = time.time()
    dev = torch.device("cuda")
    if opts.jump_only:
        cuda_build.build(["inscatter", "pathtrace", "samples", "pathtrace_variants"])
        regs = {k: v for k, v in ptxas((cuda_build.BUILD_DIR / "pathtrace_variants.log")
                                       .read_text()).items() if "<" in k}
        print(f"build: {time.time() - t0:.1f}s ptxas={json.dumps(regs)}", flush=True)
        report = dict(card=card, jump=jump_variants(dev), ptxas=regs)
        report["ok"] = report["jump"]["ok"]
        print(card, flush=True)
        print(json.dumps(report), flush=True)
        return 0 if report["ok"] else 1
    if opts.skip_only:
        cuda_build.build(["inscatter", "pathtrace", "samples", "pathtrace_variants",
                          "march_variants"])
        regs = {k: v for src in ("pathtrace_variants", "march_variants")
                for k, v in ptxas((cuda_build.BUILD_DIR / f"{src}.log").read_text()).items()
                if "<" in k}
        print(f"build: {time.time() - t0:.1f}s ptxas={json.dumps(regs)}", flush=True)
        report = dict(card=card, skip=skip_variants(dev), ptxas=regs)
        report["ok"] = report["skip"]["ok"]
        print(card, flush=True)
        print(json.dumps(report), flush=True)
        return 0 if report["ok"] else 1
    if opts.spatial_only:
        cuda_build.build(["inscatter", "pathtrace", "spatial", "spatial_variants"])
        regs = ptxas((cuda_build.BUILD_DIR / "spatial_variants.log").read_text())
        print(f"build: {time.time() - t0:.1f}s ptxas={json.dumps(regs)}", flush=True)
        report = dict(card=card, spatial=spatial_variants(dev), ptxas=regs)
        report["ok"] = report["spatial"]["ok"]
        print(card, flush=True)
        print(json.dumps(report), flush=True)
        return 0 if report["ok"] else 1
    if opts.path_only:
        cuda_build.build(["inscatter", "diff", "pathtrace", "path_adjoint",
                          "path_adjoint_variants"])
        report = dict(card=card, path=path_variants(dev))
        report["ok"] = report["path"]["ok"]
        print(card, flush=True)
        print(json.dumps(report), flush=True)
        return 0 if report["ok"] else 1
    if opts.diff_only:
        cuda_build.build(["inscatter", "diff", "diff_variants", "pathtrace", "path_adjoint",
                          "path_adjoint_variants"])
        regs = ptxas((cuda_build.BUILD_DIR / "diff_variants.log").read_text())
        print(f"build: {time.time() - t0:.1f}s ptxas={json.dumps(regs)}", flush=True)
        report = dict(card=card, diff=diff_variants(cuda_build.load("diff_variants"), dev),
                      path=path_variants(dev), ptxas=regs)
        report["ok"] = report["diff"]["ok"] and report["path"]["ok"]
        print(card, flush=True)
        print(json.dumps(report), flush=True)
        return 0 if report["ok"] else 1
    cuda_build.build(["pathtrace", "inscatter", "march", "descriptor", "samples",
                      "march_variants", "diff", "diff_variants"])
    lib = cuda_build.load("march_variants")
    lib.ds_variant.argtypes = [ctypes.c_int] * 3
    lib.ds_variant.restype = None
    lib.ds_neural_variant.argtypes = [ctypes.c_int] * 2
    lib.ds_neural_variant.restype = None
    lib.ds_samples_variant.argtypes = [ctypes.c_int] * 2
    lib.ds_samples_variant.restype = None
    lib.ds_radiance_variant.argtypes = [ctypes.c_int] * 3
    lib.ds_radiance_variant.restype = None
    regs = ptxas((cuda_build.BUILD_DIR / "march_variants.log").read_text())
    print(f"build: {time.time() - t0:.1f}s ptxas={json.dumps(regs)}", flush=True)

    report = {"card": card} if opts.collector_only else dict(card=card, **render_variants(lib, dev))
    if not opts.collector_only:
        report["diff"] = diff_variants(cuda_build.load("diff_variants"), dev)
        report["ok"] = report["ok"] and report["diff"]["ok"]
    params, static = collector_scene(dev, bake=True)
    report["K7a"] = k7a_variants(lib, params, static)
    report["K7b"] = k7b_variants(lib, params, static)
    report["sm_clock_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"sm clock, max: {report['sm_clock_mhz']}", flush=True)
    ok = report.get("ok", True)
    ok = ok and all(r["equal"] for k, r in report["K7a"].items() if k != "attempts")
    ok = ok and all(r["equal"] for k, r in report["K7b"].items() if k != "work")
    report.update(ptxas=regs, ok=ok)
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
