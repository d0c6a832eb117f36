"""Checks the committed JAX path-traced reference of the end-to-end
evaluation against the JAX package as it stands, on the CPU.

``runs/eval_e2e/renders_512x256/eval.PT.exr`` is the converged path-traced
image of the held-out scene of ``EVAL_r05.json``, written by
``tools/eval_e2e.py`` (``render_seed`` 3).  That run reused the file from
disk (``"pt_subframes": -1``), so the revision that rendered it is not
recorded.  This script renders the same scene with the JAX package on the
CPU, as ``tools/eval_e2e.py:124-235`` sets it up, for a fixed number of
subframes from the same seed, and holds the short render against the file
with ``deepestscatter_tpu_torch.utils.compare.render_agreement`` (the
reference's noise taken as negligible beside the short render's): the
image means within 4 standard errors and the share of pixel channels
past 4 sigma.  About 27 s a subframe at 512 x 256 on an 8-core CPU.

    JAX_PLATFORMS=cpu python tests/jax_reference_check.py --subframes 20

``--exr`` writes the short render's image: with ``--exr
runs/port_eval/eval.PT.jax_cpu_20sf.exr`` it made the 20-subframe JAX
render (seed 3, the JAX package on the CPU) that ``chip_smoke.py`` holds
the card's first 20 subframes against.  Prints one JSON line; exits 1
where the short render disagrees.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REFERENCE = ROOT / "runs/eval_e2e/renders_512x256/eval.PT.exr"
EVAL_JSON = ROOT / "EVAL_r05.json"


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from deepestscatter_tpu import tasks
    from deepestscatter_tpu.config import CameraConfig, CloudRendering, SceneConfig
    from deepestscatter_tpu.data import records
    from deepestscatter_tpu.render.progressive import ProgressiveRenderer
    from deepestscatter_tpu.utils import exr

    from deepestscatter_tpu_torch.utils import compare

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--subframes", type=int, default=20,
                        help="subframes to render (a multiple of 10, the ticks' size)")
    parser.add_argument("--save", default=None,
                        help="write the short render's Welford state to this .npz")
    parser.add_argument("--exr", default=None,
                        help="write the short render's image (its per-pixel means) to this EXR")
    opts = parser.parse_args(argv)
    held = json.loads(EVAL_JSON.read_text())["held_out_scene"]
    w, h = json.loads(EVAL_JSON.read_text())["resolution"]
    setup = np.zeros(1, records.SCENE_SETUP)[0]
    setup["cloud_path"] = held["cloud"].encode()
    setup["cloud_size_m"] = held["size_m"]
    setup["light_direction"] = np.asarray(held["light"], np.float32)
    base = SceneConfig(rendering=CloudRendering(rr_start_depth=64, rr_survival=0.98,
                                                march_dtype="uint8"))
    base = dataclasses.replace(base, camera=CameraConfig(width=w, height=h))
    t0 = time.time()
    cfg, params, static = tasks.scene_from_setup(setup, base)
    prog = ProgressiveRenderer(cfg, params, static, seed=3)
    while int(prog.state.subframe_id) < opts.subframes:
        prog.tick()
        print(f"subframe {int(prog.state.subframe_id)}: {time.time() - t0:.0f}s", flush=True)
    st = prog.state
    mean, m2 = np.asarray(st.mean).reshape(h, w, 3), np.asarray(st.m2).reshape(h, w, 3)
    count = np.asarray(st.count).reshape(h, w)
    if opts.save:
        np.savez(opts.save, mean=mean, m2=m2, count=count)
    if opts.exr:
        Path(opts.exr).parent.mkdir(parents=True, exist_ok=True)
        exr.write_exr(opts.exr, mean)
    a = compare.render_agreement(mean, m2, count, exr.read_exr(str(REFERENCE)),
                                 reference_noise=0.0)
    ok = abs(a.mean_z) <= compare.Z_MAX
    print(json.dumps(dict(subframes=int(st.subframe_id), seconds=round(time.time() - t0, 1),
                          eval_pt_mean=json.loads(EVAL_JSON.read_text())["pt_mean"],
                          **a._asdict(), ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
