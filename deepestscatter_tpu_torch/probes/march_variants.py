"""Alternatives of the two march kernels, timed on one card.

``csrc/march_variants.cu`` builds, beside the kernels the package runs:

- K4 (``csrc/pathtrace.cu``) with its item queue at each lookahead in
  ``QUEUE_LOOKAHEADS``, and as one thread per pixel over its samples at
  each lookahead in ``PIXEL_LOOKAHEADS``; lookahead 0 is that mapping with
  the march it had before the queue (``trace_sample``: int64 tap offsets,
  IEEE divisions by the box size);
- K3 (``csrc/inscatter.cu``) with each number of voxels a thread in
  ``VOXELS``.

Every alternative runs at the main paths' operating point (the 256^3
procedural cumulus of seed 11, 2000 m, uint8 textures; K4 on the 512^2
tick of 2 subframes, K3 on the whole grid with early-out) and must equal
the package's kernel bitwise.  Times are CUDA-event means over 20 calls
(K4) or 3 (K3), the alternatives timed in turns, forward then backward,
twice.

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

import torch

from .. import config, cuda_build
from ..data import procedural
from ..render import camera, inscatter, pathtracer
from ..render.inscatter import with_baked_inscatter
from ..scene import build_scene

QUEUE_LOOKAHEADS = (1, 2, 4, 8)
PIXEL_LOOKAHEADS = (0, 1, 2)
VOXELS = (1, 2, 4, 8)
SIZE = 512
SUBFRAMES = 2


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


def main() -> int:
    if not torch.cuda.is_available():
        print("march_variants: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    t0 = time.time()
    cuda_build.build(["pathtrace", "inscatter", "march_variants"])
    lib = cuda_build.load("march_variants")
    lib.ds_variant.argtypes = [ctypes.c_int] * 3
    lib.ds_variant.restype = None
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

    print(card, flush=True)
    print(json.dumps({"card": card, "steps": steps, "K4": k4, "K3": k3, "ptxas": regs,
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
