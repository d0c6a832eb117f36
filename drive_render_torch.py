#!/usr/bin/env python3
"""Drive the PyTorch port (``deepestscatter_tpu_torch``) end to end through
its public API, as a user would, and check what comes out.

    python3 drive_render_torch.py                 # on the card (the default)
    python3 drive_render_torch.py --device cpu --res 16 --width 16 --height 8 \\
        --ticks 1 --subframes 2 --max-depth 20 --size-m 600   # a tiny CPU run

Steps, a line each: a procedural cumulus (seed 11) and its scene, the
in-scatter bake; progressive path-traced ticks (``ProgressiveRenderer``),
the image mean (near 1.3 for the default cloud: 64^3, 2000 m, 128 x 64, 30
subframes); an EXR write and read-back; the same seed giving equal images
and two seeds different ones, for the path tracer and the RPNN frame; an
RPNN frame (``DisneyRenderer``, random weights from a seed); a probe-lattice
bake and a baked (BNN) frame (``BakedRenderer``); the empty-cloud probe (box
hits black, misses the sky) and an axis-parallel ray; a tick with the
empty-cell exit jump and a tick with the occupancy-block skip, each within
2 % of the default tick's image mean (same seed) and with lattice steps
skipped.  It ends with ``ALL DRIVE STEPS PASSED``; a failed check raises.
``--device cuda`` (the default) raises where there is no card.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import deepestscatter_tpu_torch as port
from deepestscatter_tpu_torch import config
from deepestscatter_tpu_torch.data import procedural
from deepestscatter_tpu_torch.device import resolve_device
from deepestscatter_tpu_torch.models.probes import init_light_probe_model, init_probe_renderer_model
from deepestscatter_tpu_torch.models.rpnn import init_disney_model
from deepestscatter_tpu_torch.ops import march as march_ops
from deepestscatter_tpu_torch.render import camera as cam
from deepestscatter_tpu_torch.render import pathtracer
from deepestscatter_tpu_torch.utils import exr

#: The default cloud's path-traced image mean (the JAX package's recipe:
#: 64^3 cumulus of seed 11, 2000 m, 128 x 64, 30 subframes) and the band
#: the port's must fall in.
PT_MEAN = 1.3
PT_MEAN_TOL = 0.15
DEFAULT_CLOUD = dict(res=64, size_m=2000.0, max_depth=2000)
#: A skipping tick's image mean against the default tick's (same seed).
SKIP_REL_TOL = 0.02


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def timed(label: str, fn):
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, f"{label} {time.perf_counter() - t0:.2f}s"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, default=DEFAULT_CLOUD["res"])
    ap.add_argument("--size-m", type=float, default=DEFAULT_CLOUD["size_m"])
    ap.add_argument("--max-depth", type=int, default=DEFAULT_CLOUD["max_depth"])
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--subframes", type=int, default=10, help="subframes a tick")
    ap.add_argument("--out", default=None, help="directory for the EXRs (default: a temporary one)")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    w, h = a.width, a.height
    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(0)})" if dev.type == "cuda" else ""),
          flush=True)
    tmp = None
    if a.out is None:
        tmp = tempfile.TemporaryDirectory()
    out = Path(a.out or tmp.name)
    out.mkdir(parents=True, exist_ok=True)

    def scene_cfg(occupancy=False):
        return config.SceneConfig(
            cloud=config.CloudModel(size_m=a.size_m),
            camera=config.CameraConfig(width=w, height=h),
            rendering=config.CloudRendering(max_depth=a.max_depth, occupancy_skipping=occupancy),
            progressive=config.ProgressiveConfig(subframes_per_tick=a.subframes),
        )

    cfg = scene_cfg()
    density = procedural.cumulus(resolution=a.res, seed=11)
    (params, static), line = timed("scene", lambda: port.build_scene(cfg, density, device=dev))
    params, bake_line = timed("in-scatter bake",
                              lambda: port.with_baked_inscatter(params, static, device=dev))
    print(f"{line}: grid={static.grid_shape} mips={static.n_mips}; {bake_line}", flush=True)

    # -- path-traced ticks ---------------------------------------------------
    def ticks(st, seed, n, p=params):
        r = port.ProgressiveRenderer(cfg, p, st, seed=seed, device=dev)
        for _ in range(n):
            left = r.tick()
        return r, left

    (pr, left), line = timed(f"PT {a.ticks} ticks", lambda: ticks(static, 1, a.ticks))
    hdr = pr.hdr_image()
    pt_mean = float(hdr.mean())
    print(f"{line} ({pr.state.subframe_id} subframes): unconverged={left} image mean={pt_mean:.6f} "
          f"max={float(hdr.max()):.4f}", flush=True)
    check(bool(np.isfinite(hdr).all()), "PT image has a non-finite pixel")
    default_cloud = (a.res, a.size_m, a.max_depth) == tuple(DEFAULT_CLOUD.values())
    if default_cloud:
        check(abs(pt_mean - PT_MEAN) <= PT_MEAN_TOL,
              f"PT mean {pt_mean} is not within {PT_MEAN_TOL} of {PT_MEAN}")
        print(f"PT mean within {PT_MEAN_TOL} of {PT_MEAN} (the default cloud)", flush=True)
    else:
        check(0.0 < pt_mean < 10.0, f"PT mean {pt_mean} outside (0, 10)")

    exr.write_exr(str(out / "pt.exr"), hdr)
    back = exr.read_exr(str(out / "pt.exr"))
    check(back.shape == hdr.shape and np.allclose(back, hdr, atol=1e-6), "EXR round trip differs")
    print(f"EXR round trip OK ({out / 'pt.exr'})", flush=True)

    one, _ = ticks(static, 1, 1)
    again, _ = ticks(static, 1, 1)
    other, _ = ticks(static, 2, 1)
    check(np.array_equal(one.hdr_image(), again.hdr_image()), "PT: the same seed gave another image")
    check(not np.array_equal(one.hdr_image(), other.hdr_image()), "PT: two seeds gave one image")
    print("PT determinism: same seed equal, seeds 1 and 2 differ", flush=True)

    # -- RPNN neural frame -----------------------------------------------------
    basis = cam.camera_basis(cfg.camera)
    model = init_disney_model(0, device=dev)
    renderer = port.DisneyRenderer(model, device=dev)
    frame, line = timed(f"NN frame {w}x{h}",
                        lambda: renderer.render_frame(params, static, w, h, basis, seed=5))
    frame2 = renderer.render_frame(params, static, w, h, basis, seed=5)
    frame6 = renderer.render_frame(params, static, w, h, basis, seed=6)
    nn = frame.cpu().numpy()
    print(f"{line}: image mean={float(nn.mean()):.6f} finite={bool(np.isfinite(nn).all())}",
          flush=True)
    check(bool(np.isfinite(nn).all()), "NN frame has a non-finite pixel")
    check(torch.equal(frame, frame2) and not torch.equal(frame, frame6),
          "NN frames: the same seed must repeat and two seeds differ")
    exr.write_exr(str(out / "nn.exr"), nn)
    print("NN determinism: same seed equal, seeds 5 and 6 differ", flush=True)

    # -- baked (BNN) frame -------------------------------------------------------
    brenderer, line = timed("probe bake", lambda: port.BakedRenderer(
        params, static, init_light_probe_model(1, device=dev), init_probe_renderer_model(2, device=dev),
        device=dev))
    bframe, bline = timed("BNN frame", lambda: brenderer.render_frame(params, static, w, h, basis,
                                                                        seed=5))
    bnn = bframe.cpu().numpy()
    print(f"{line} lattice={brenderer.lattice}; {bline}: image mean={float(bnn.mean()):.6f} "
          f"finite={bool(np.isfinite(bnn).all())}", flush=True)
    check(bool(np.isfinite(bnn).all()), "BNN frame has a non-finite pixel")

    # -- probes: an empty cloud, an axis-parallel ray ----------------------------
    p2, s2 = port.build_scene(cfg, np.zeros((16, 16, 16), np.float32), device=dev)
    o2, d2 = cam.generate_rays(basis, 32, 16, dev)
    f2 = port.render_disney(p2, s2, model, o2, d2, device=dev)
    hit2, _ = cam.intersect_box(o2, d2, s2, p2.bbox_size)
    miss = cam.miss_radiance(p2, s2, d2)
    check(bool((f2[hit2] == 0.0).all()), "empty cloud: box hits must be black")
    check(torch.allclose(f2[~hit2], miss[~hit2]), "empty cloud: misses must shade the sky")
    print("probe: empty cloud gives black box hits and sky misses", flush=True)
    o3 = torch.tensor([[0.0, 0.0, -3.0], [0.0, -3.0, 0.0]], device=dev)
    d3 = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]], device=dev)
    f3 = port.render_disney(params, static, model, o3, d3, device=dev)
    r3 = pathtracer.render_subframe(params, static, o3, d3, 1, 1, device=dev)
    check(bool(torch.isfinite(f3).all()) and bool(torch.isfinite(r3).all()),
          "an axis-parallel ray gave a non-finite value")
    print("probe: axis-parallel rays finite (NN and PT)", flush=True)

    # -- a tick with each empty-space skip -------------------------------------
    bcfg = scene_cfg(occupancy=True)
    bparams, bstatic = port.build_scene(bcfg, density, device=dev)
    bparams = port.with_baked_inscatter(bparams, bstatic, device=dev)
    base, _ = ticks(static, 1, 1)
    base_mean = float(base.hdr_image().mean())
    o, d = cam.generate_rays(basis, w, h, dev)
    hit, t_hit = cam.intersect_box(o, d, static, params.bbox_size)
    entry = cam.entry_points(o, d, t_hit, params.bbox_size)
    ids = torch.arange(o.shape[0], device=dev)
    for name, p, st in (("cell jump", params, dataclasses.replace(static, march_empty_skip=True)),
                        ("block skip", bparams, bstatic)):
        check(march_ops.skip_mode(st) != march_ops.SKIP_NONE, f"{name}: the scene takes no skip")
        r, line = timed(f"PT tick, {name}", lambda: ticks(st, 1, 1, p)[0])
        img = r.hdr_image()
        m = float(img.mean())
        work = pathtracer.scatter_loop(p, st, entry, d, hit, ids, 1, 1, a.subframes)
        jumped, steps = int(work.jumped.sum()), int(work.steps.sum())
        rel = abs(m - base_mean) / base_mean
        print(f"{line}: image mean={m:.6f} (default {base_mean:.6f}, rel diff {rel:.2e}) "
              f"steps sampled={steps} jumped={jumped}", flush=True)
        check(bool(np.isfinite(img).all()) and rel <= SKIP_REL_TOL,
              f"{name}: image mean {m} not within {SKIP_REL_TOL} of {base_mean}")
        check(jumped > 0, f"{name}: no lattice step was skipped")
    if tmp is not None:
        tmp.cleanup()
    print("ALL DRIVE STEPS PASSED", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
