"""The port's converged path-traced render of the end-to-end evaluation's
held-out scene, held against the JAX package's committed ground truth,
with what the gate's noise model rests on.

``chip_smoke.py``'s ``JAX ground truth`` phase gates seed 3 at the
reference's depth and the pooled renders of seeds 4-6.  This script
measures what those gates assume, on the same scene
(``EVAL_r05.json``'s ``held_out_scene``, ``tasks.eval_scene`` and
``tasks.scene_from_setup``) and reference
(``runs/eval_e2e/renders_512x256/eval.PT.exr``):

- seed 3, the reference's own seed, tick by tick: after every tick the
  mean absolute difference of the running image to the reference and the
  share of channels within 1e-6 (relative).  The same seed draws mostly the
  same paths, so the running image comes closest to the reference where it
  has as many subframes as the reference had; there it prints the paired
  difference of the image means with its standard error
  (``utils.compare.paired_difference``);
- each seed of ``--seeds`` (none of them the reference's) to the CI gate
  (``ProgressiveRenderer.run()``): ``utils.compare.render_agreement``, the
  reference's noise taken as that of a render of the depth the scan found,
  the z-score had a pixel's three channels been taken as independent, and
  mean((render - reference)^2) / mean(se^2) - 1, an estimate of the
  reference's pixel variance over the render's;
- the spread of the seeds' image means beside the standard error the
  gate's model predicts for one render, pairs of seeds' mean((a - b)^2)
  over their summed se^2 (1 if the per-pixel standard errors are right),
  and the seeds pooled (``pool_renders``) against the reference.

Run on the card from the repo root::

    python -m deepestscatter_tpu_torch.probes.ground_truth [--seeds 4 5 ...]

Prints one JSON line a part; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import tasks
from ..render import progressive
from ..utils import compare, exr

ROOT = Path(__file__).resolve().parents[2]
EVAL_JSON = ROOT / "EVAL_r05.json"
REFERENCE = ROOT / "runs/eval_e2e/renders_512x256/eval.PT.exr"
REFERENCE_SEED = 3


def pixel_var(m2: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Per pixel channel variance of the mean, m2 / (n (n - 1))."""
    n = count.astype(np.float64).reshape(count.shape[:2] + (1,))
    return np.where(n >= 2.0, m2.astype(np.float64) / np.maximum(n * (n - 1.0), 1.0), 0.0)


def scan_reference_seed(cfg, params, static, ref_t, dev) -> dict:
    """Seed 3 tick by tick against the reference (see the module doc)."""
    r = progressive.ProgressiveRenderer(cfg, params, static, seed=REFERENCE_SEED, device=dev)
    curve, best, best_mean = [], None, None
    while r.state.subframe_id < cfg.progressive.max_subframes:
        r.tick()
        d = (r.state.mean - ref_t).abs()
        mad = float(d.mean())
        close = float((d <= 1e-6 * ref_t.abs()).float().mean())
        curve.append((r.state.subframe_id, mad, close))
        if best is None or mad < best[1]:
            best, best_mean = curve[-1], r.state.mean.clone()
    h, w = cfg.camera.height, cfg.camera.width
    at = best_mean.reshape(h, w, 3).cpu().numpy()
    ref = ref_t.reshape(h, w, 3).cpu().numpy()
    diff, se = compare.paired_difference(at, ref)
    step = max(1, len(curve) // 20)
    return dict(seed=REFERENCE_SEED, best_subframes=best[0], best_mean_abs_diff=best[1],
                best_close_share=best[2], end_subframes=curve[-1][0],
                end_mean_abs_diff=curve[-1][1], end_close_share=curve[-1][2],
                image_mean=float(at.astype(np.float64).mean()),
                reference_mean=float(ref.astype(np.float64).mean()), diff=diff,
                paired_se=se, paired_z=diff / se,
                curve=[curve[i] for i in range(0, len(curve), step)])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=list(range(4, 12)))
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ground_truth: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    record = json.loads(EVAL_JSON.read_text())
    width, height = record["resolution"]
    reference = exr.read_exr(str(REFERENCE))
    setup, base = tasks.eval_scene(record["held_out_scene"], width, height)
    cfg, params, static = tasks.scene_from_setup(setup, base, device=dev)
    ref_t = torch.as_tensor(reference, device=dev).reshape(-1, 3)
    scan = scan_reference_seed(cfg, params, static, ref_t, dev)
    print(json.dumps(scan), flush=True)
    depth = scan["best_subframes"]  # the reference's subframes

    renders, means = [], []
    for seed in opts.seeds:
        r = progressive.ProgressiveRenderer(cfg, params, static, seed=seed, device=dev)
        t0 = time.time()
        r.run()
        torch.cuda.synchronize()
        st = r.state
        state = (st.mean.reshape(height, width, 3).cpu().numpy(),
                 st.m2.reshape(height, width, 3).cpu().numpy(),
                 st.count.reshape(height, width).cpu().numpy())
        renders.append(state)
        a = compare.render_agreement(*state, reference,
                                     reference_noise=float(np.sqrt(st.subframe_id / depth)))
        var = pixel_var(state[1], state[2])
        se_independent = float(np.sqrt(var.sum() * (1.0 + st.subframe_id / depth)) / var.size)
        d2 = (state[0].astype(np.float64) - reference) ** 2
        means.append(a.mean)
        print(json.dumps(dict(
            seed=seed, run_s=round(time.time() - t0, 2), subframes=st.subframe_id,
            unconverged=int(progressive.unconverged_count(st, cfg.progressive)),
            passes=a.passes(), **a._asdict(),
            mean_z_channels_independent=(a.mean - a.reference_mean) / se_independent,
            reference_var_over_render_var=float(d2.mean() / var.mean()) - 1.0)), flush=True)

    pairs = []
    for (ma, m2a, ca), (mb, m2b, cb) in zip(renders, renders[1:]):
        d2 = (ma.astype(np.float64) - mb) ** 2
        pairs.append(float(d2.mean() / (pixel_var(m2a, ca).mean() + pixel_var(m2b, cb).mean())))
    k = len(renders)
    pooled_state = compare.pool_renders(renders)
    pooled = compare.render_agreement(
        *pooled_state, reference, reference_noise=float(np.sqrt(pooled_state[2].max() / depth)))
    one = compare.render_agreement(*renders[0], reference, reference_noise=0.0)
    print(json.dumps(dict(
        seeds=opts.seeds, mean_of_means=float(np.mean(means)),
        std_of_means=float(np.std(means, ddof=1)) if k > 1 else 0.0,
        predicted_se_one_render=one.mean_se, pair_diff_over_se2=pairs,
        pooled=dict(passes=pooled.passes(), **pooled._asdict()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
