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
  (steps over 32 x march slots) and the crossings a resolve step handles.

Every alternative runs at the main paths' operating point (the 256^3
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

    python -m deepestscatter_tpu_torch.probes.march_variants [--collector-only]

``--collector-only`` runs K7a's and K7b's alternatives alone.  Prints
one line an alternative, then one JSON object as the last line; exits 1
without a card or if an alternative disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
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


def in_turns(fns: Dict[str, Callable[[], object]], reps: int) -> Dict[str, List[float]]:
    """Each function's time, measured forward then backward over the keys,
    twice."""
    ms: Dict[str, List[float]] = {k: [] for k in fns}
    keys = list(fns)
    for k in (keys + keys[::-1]) * 2:
        ms[k].append(time_ms(fns[k], reps))
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


def k7b_variants(lib, params, static) -> Dict[str, dict]:
    """K7b in each design of K7B_DESIGNS against the package's, at the
    radiance stage's first update on the collector's scene: records and
    folds bitwise."""
    n = records.BATCH_SIZE
    cfg = config.PointRadianceConfig()
    rs = collectors.radiance_static(static)
    s = collectors.generate_scatter_samples(params, static, n, 0)
    entry = (s.positions + 0.5 * params.bbox_size).contiguous()
    replicas = max(1, cfg.max_threads // collectors.bucket_size(n))
    launches = cfg.launches_per_update
    base = torch.zeros(n, dtype=torch.int64, device=entry.device)
    lanes = collectors._lanes(entry, s.directions.contiguous(),
                              torch.arange(n, device=entry.device), base, replicas, launches)
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
    parser.add_argument("--collector-only", action="store_true",
                        help="time only K7a's and K7b's alternatives")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("march_variants: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    t0 = time.time()
    cuda_build.build(["pathtrace", "inscatter", "march", "descriptor", "samples",
                      "march_variants"])
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

    dev = torch.device("cuda")
    report = {"card": card} if opts.collector_only else dict(card=card, **render_variants(lib, dev))
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
