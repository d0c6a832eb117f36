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
- K7a (``csrc/samples.cu``) with each number of lanes a sample in
  ``SAMPLE_LANES`` (the package runs 32).

Every alternative runs at the main paths' operating point (the 256^3
procedural cumulus of seed 11, 2000 m, uint8 textures; K4 on the 512^2
tick of 2 subframes, K3 on the whole grid with early-out, K1 on both passes
of the 512 x 256 neural frame's rays, K2 on that frame's shading points in
one launch; K7a on the dataset collector's 2,048 samples of that cloud
with the ``Front`` light, as ``tasks.collect`` prepares it) and must equal
the package's kernel bitwise.  Times are
CUDA-event means over 20 calls (K4, K1, K2, K7a) or 3 (K3), the alternatives
timed in turns, forward then backward, twice.

Run on the card::

    python -m deepestscatter_tpu_torch.probes.march_variants

Prints one line an alternative, then one JSON object as the last line;
exits 1 without a card or if an alternative disagrees.
"""

from __future__ import annotations

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
#: K7a's alternatives: lanes a sample.
SAMPLE_LANES = (8, 32)
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


def k7a_variants(lib, dev) -> Dict[str, dict]:
    """K7a at each number of lanes in SAMPLE_LANES against the package's,
    on the collector's scene and batch."""
    setup = np.zeros(1, records.SCENE_SETUP)[0]
    setup["cloud_path"] = b"procedural:256:11"
    setup["cloud_size_m"] = 2000.0
    setup["light_direction"] = config.LIGHT_DIRECTIONS["Front"]
    _, params, static = tasks.scene_from_setup(setup, bake=False, device=dev)
    n = records.BATCH_SIZE
    ref = collectors._launch_samples(params, static, n, 0)
    out: Dict[str, dict] = {}
    fns = {}
    for g in SAMPLE_LANES:
        def run(g=g):
            lib.ds_samples_variant(g)
            return collectors._launch_samples(params, static, n, 0, lib=lib)

        out[f"G={g}"] = dict(equal=all(torch.equal(a, b) for a, b in zip(run(), ref)))
        fns[f"G={g}"] = run
    for key, ms in in_turns(fns, 20).items():
        out[key]["ms"] = ms
        print(f"K7a {key}: {json.dumps(out[key])}", flush=True)
    return out


def main() -> int:
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
    lib.ds_samples_variant.argtypes = [ctypes.c_int]
    lib.ds_samples_variant.restype = None
    regs = ptxas((cuda_build.BUILD_DIR / "march_variants.log").read_text())
    print(f"build: {time.time() - t0:.1f}s ptxas={json.dumps(regs)}", flush=True)

    dev = torch.device("cuda")
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

    ok = True
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
            ok = ok and equal
            if pixel:
                simt = simt_per_pixel(got.steps)
            else:
                simt = steps / (32.0 * int(pathtracer.scatter_loop.last_counters[1].item()))
            k4[key] = dict(equal=equal, simt_efficiency=simt)
            k4_fns[key] = run
    for key, ms in in_turns(k4_fns, 20).items():
        k4[key]["ms"] = ms
        print(f"K4 {key}: {json.dumps(k4[key])}", flush=True)

    ref3 = inscatter._launch(params, static, True)
    k3: Dict[str, dict] = {}
    k3_fns = {}
    for v in VOXELS:
        def bake(v=v):
            lib.ds_variant(0, 0, v)  # (K4's choice unused here)
            return inscatter._launch(params, static, True, lib=lib)

        equal = torch.equal(bake(), ref3)
        ok = ok and equal
        k3[f"V={v}"] = dict(equal=equal)
        k3_fns[f"V={v}"] = bake
    for key, ms in in_turns(k3_fns, 3).items():
        k3[key]["ms"] = ms
        print(f"K3 {key}: {json.dumps(k3[key])}", flush=True)

    pass1, pass2, points = neural_inputs(params, static, dev)
    print(f"neural frame: pass1_rays={pass1[0].shape[0]} pass2_rays={pass2[0].shape[0]} "
          f"points={points[0].shape[0]}", flush=True)
    k1 = k1_variants(lib, params, static, pass1, pass2)
    k2 = k2_variants(lib, params, static, points)
    k7a = k7a_variants(lib, dev)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60).stdout.strip()
    print(f"sm clock, max: {clocks}", flush=True)
    ok = ok and all(r["equal"] for k, r in k1.items() if k != "steps")
    ok = ok and all(r["equal"] for r in k2.values())
    ok = ok and all(r["equal"] for r in k7a.values())

    print(card, flush=True)
    print(json.dumps({"card": card, "sm_clock_mhz": clocks, "steps": steps, "K4": k4, "K3": k3,
                      "K1": k1, "K2": k2, "K7a": k7a, "ptxas": regs, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
